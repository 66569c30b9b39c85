"""The port's CUDA kernels (K1 screen_fused, K2 weighted_cdf_sum, the gate
prune's gate_counts) and their card paths against their plain versions,
bit-equal (TF32 off for the plain
versions' f32 matmuls, which then sum exact integers); the sketch build's
torch ops (fed by the native FASTA reader) and the dense engine (indicator
products, the ERTL-MLE) on the card against the same ops on the CPU, the
native host builder and the host oracle.

Needs an NVIDIA card: every test skips without one (the kernels have no CPU
mode). Imports neither JAX nor the reference package, so it also runs on
the machine with the card, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py
"""

import filecmp
import gzip
import os

import numpy as np
import pytest
import torch

import gate_cases

from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.ops import (estimators, pairwise,
                                                  screen)
from cuda_selection_criteria_tpu_torch.parallel import screened
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, select_pairs)
from cuda_selection_criteria_tpu_torch.utils import hostref, synth


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, lo, hi, n, p, n_bands=4):
    rng = np.random.default_rng(seed)
    regs = rng.integers(lo, hi, size=(n, 1 << p), dtype=np.uint8)
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    e[:3] = 0.0
    aux = rng.integers(0, 1 << 63, size=(n, 4 * n_bands), dtype=np.uint64)
    aux[1::5] = aux[0]
    fp = screened.band_fingerprints_np(aux, 4, n_bands)
    return regs, e, fp


def _compare(dev, regs, e, fp, rows, cols, vals, p, ti, use_cb, use_smh,
             tau_scr=0.4, tau_cb=0.35, n_real=None):
    args = [torch.from_numpy(np.asarray(x)).to(dev)
            for x in (regs, rows, cols, e, fp)]
    n_real = regs.shape[0] - 5 if n_real is None else n_real
    kw = dict(n_real=n_real, tau_scr=tau_scr, tau_cb=tau_cb, p=p,
              values=vals, ti=ti, n_bands=fp.shape[1], use_cb=use_cb,
              use_smh=use_smh)
    before = screen.screen_hits_fused.launches
    got = screen.screen_hits_fused(*args, **kw)
    want = screen._screen_hits_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert screen.screen_hits_fused.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return int(got[1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True), (False, False),
])
@pytest.mark.parametrize("with_zeros", [True, False])
def test_kernel_matches_plain_p8(cuda, use_cb, use_smh, with_zeros):
    regs, e, fp = _inputs(31 + use_cb + 2 * use_smh,
                          0 if with_zeros else 2, 11, 192, 8)
    _compare(cuda, regs, e, fp, np.array([0, 0, 1, 2], np.int32),
             np.array([0, 2, 1, 2], np.int32), screen.bank_values(regs), 8,
             64, use_cb, use_smh)


@pytest.mark.cuda
@pytest.mark.parametrize("ti", [128, 256])
def test_kernel_matches_plain_multi_cta_truncated(cuda, ti):
    """Several 64 x 64 CTAs per schedule tile, p=10, a truncated value
    list, off-diagonal and diagonal tiles, planted near-duplicates."""
    rng = np.random.default_rng(7 + ti)
    regs = synth.synthetic_regs(512, rng.integers(300, 3000, 512), 10, rng)
    aux = synth.synthetic_aux(512, 16, rng)
    synth.plant_near_duplicates(regs, aux, rng, 40)
    e = np.trunc(host_cards(regs, 10)).astype(np.float32)
    e[:3] = 0.0
    fp = screened.band_fingerprints_np(aux, 4, 4)
    vals = screen.truncate_values(screen.bank_values(regs), e.max(), 10)
    nb = 512 // ti
    rows, cols = np.triu_indices(nb)
    hits = _compare(cuda, regs, e, fp, rows.astype(np.int32),
                    cols.astype(np.int32), vals, 10, ti, True, False,
                    tau_scr=0.1, tau_cb=0.05)
    assert hits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 6, 14, 16])
@pytest.mark.parametrize("use_smh", [True, False])
def test_kernel_matches_plain_p(cuda, p, use_smh):
    """Register counts below one pipeline stage of 1024 (p = 5, 6: planes
    padded with zero words) and above it (p = 14, 16), 11 bins (more than
    one group), ti = 64 and 128."""
    regs, e, fp = _inputs(40 + p, 0, 12, 256, p)
    vals = screen.bank_values(regs)
    assert len(vals) - 1 > 2
    for ti, rows, cols in ((64, [0, 0, 1, 3], [0, 2, 1, 3]),
                           (128, [0, 0, 1], [0, 1, 1])):
        _compare(cuda, regs, e, fp, np.array(rows, np.int32),
                 np.array(cols, np.int32), vals, p, ti, True, use_smh,
                 tau_scr=0.9, tau_cb=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", [1, 2, 3, 5, 8])
def test_kernel_matches_plain_bin_groups(cuda, nbins):
    """1 to 8 bins, odd and even, with and without zero registers: the
    bin loop, the S folds and the Z of bin 0."""
    for lo in (0, 1):
        regs, e, fp = _inputs(60 + nbins + lo, lo, lo + nbins + 1, 256, 9)
        vals = screen.bank_values(regs)
        assert len(vals) - 1 == nbins
        _compare(cuda, regs, e, fp, np.array([0, 0, 1, 1], np.int32),
                 np.array([0, 1, 1, 3], np.int32), vals, 9, 64, False, False,
                 tau_scr=0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["below_diagonal", "n_real_0", "cb"])
def test_kernel_all_blocks_skipped(cuda, case):
    """A launch in which no pair passes its gates: every block takes the
    skip, hits all zero, counts zero, equal to the plain version."""
    regs, e, fp = _inputs(71, 0, 12, 512, 8)
    if case == "cb":
        e = np.where(np.arange(512) < 128, 1.0, 4000.0).astype(np.float32)
    rows, cols = {"below_diagonal": ([1, 3, 2], [0, 1, 0]),
                  "n_real_0": ([0, 0, 1], [0, 1, 1]),
                  "cb": ([0], [1])}[case]
    hits = _compare(cuda, regs, e, fp, np.array(rows, np.int32),
                    np.array(cols, np.int32), screen.bank_values(regs), 8,
                    128, True, False, tau_scr=0.9, tau_cb=0.5,
                    n_real=0 if case == "n_real_0" else None)
    assert hits == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ti,rows,cols", [(64, [0], [1]), (128, [0], [0]),
                                          (64, [0, 1], [1, 0])])
def test_kernel_one_live_pair_at_block_corner(cuda, ti, rows, cols):
    """Gates that pass in exactly one pair, (i, j) = (63, 64): the corner
    of a 64-edge block, and inside one 128-edge block."""
    regs, e, fp = _inputs(83, 0, 12, 256, 8)
    e[:] = 1.0e6
    fp = np.arange(256 * 4, dtype=np.int32).reshape(256, 4)
    fp[64, 2] = fp[63, 2]
    regs[64] = regs[63]
    hits = _compare(cuda, regs, e, fp, np.array(rows, np.int32),
                    np.array(cols, np.int32), screen.bank_values(regs), 8, ti,
                    False, True, tau_scr=0.9)
    assert hits == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_real", [37, 100, 130, 200])
def test_kernel_n_real_inside_a_block(cuda, n_real):
    regs, e, fp = _inputs(90 + n_real, 0, 12, 256, 8)
    e[:] = 1.0e6
    hits = _compare(cuda, regs, e, fp, np.array([0, 0, 1], np.int32),
                    np.array([0, 1, 1], np.int32), screen.bank_values(regs), 8,
                    128, True, False, tau_scr=0.9, n_real=n_real)
    assert hits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("crit", ["smh_a", "cb", "baseline", "smh_only"])
def test_engine_on_cuda_matches_cpu(cuda, crit):
    rng = np.random.default_rng(5)
    regs = synth.synthetic_regs(300, rng.integers(400, 900, 300), 10, rng)
    aux = synth.synthetic_aux(300, 16, rng)
    synth.plant_near_duplicates(regs, aux, rng, 12)
    bank = SketchBank(names=[f"g{i}" for i in range(300)], regs=regs, p=10,
                      aux_kind="smh", aux=aux, aux_param=16)
    params = SelectionParams(tau=0.5, criterion=crit)
    before = screen.screen_hits_fused.launches
    got = screened.select_pairs_screened(bank, params, ti=128, chunk=4,
                                         device=cuda)
    assert screen.screen_hits_fused.launches > before
    want = screened.select_pairs_screened(bank, params, ti=128, chunk=4,
                                          device="cpu")
    assert got == want and len(got) >= 12


@pytest.mark.cuda
def test_device_hist_fn_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    regs = rng.integers(0, 25, size=(40, 1 << 8), dtype=np.uint8)
    bank = SketchBank(names=[f"g{i}" for i in range(40)], regs=regs, p=8)
    params = SelectionParams(tau=0.3, criterion="cb")
    ii, kk = np.triu_indices(40, 1)
    for tau in (0.3, -100.0):
        outs = [screened.ScreenPlan(bank, params, 64, device=d)
                .device_hist_fn(chunk=100, tau=tau)(ii, kk)
                for d in (cuda, "cpu")]
        np.testing.assert_array_equal(*outs)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_cuda(cuda):
    regs = torch.zeros((128, 256), dtype=torch.int32, device=cuda)
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        screen.screen_hits_fused(
            regs, tiles, tiles, torch.zeros(128, device=cuda),
            torch.zeros((128, 1), dtype=torch.int32, device=cuda), 128, 0.1,
            0.1, 8, (0, 1), 64, 1, True, False)


def _k2_compare(dev, regs, rows, cols, vals, p, ti, tj, regs_cols=None):
    t = [torch.from_numpy(np.asarray(x)).to(dev) for x in (regs, rows, cols)]
    kw = dict(ti=ti, tj=tj, regs_cols=None if regs_cols is None else
              torch.from_numpy(regs_cols).to(dev))
    before = screen.screen_s_z.launches
    s, z = screen.screen_s_z(*t, p, vals, **kw)
    ws, wz = screen._screen_s_z_plain(*t, p, vals, **kw)
    torch.cuda.synchronize()
    assert screen.screen_s_z.launches == before + 1
    assert s.shape == (len(rows), ti, tj) and s.dtype == torch.float32
    assert torch.equal(s, ws)
    assert (z is None) == (wz is None) == (vals[0] != 0)
    if z is not None:
        assert torch.equal(z, wz)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 6, 7, 8, 9, 10, 14])
@pytest.mark.parametrize("case", ["zeros", "no_zeros", "truncated",
                                  "regs_cols"])
def test_k2_matches_plain(cuda, p, case):
    """K2 against its plain version at ti=64, tj=128: zeros present and
    absent, a truncated value list, a separate column bank."""
    lo, hi = {"zeros": (0, 13), "no_zeros": (3, 15), "truncated": (0, 26),
              "regs_cols": (0, 13)}[case]
    rng = np.random.default_rng(17 * p + lo + hi)
    regs = rng.integers(lo, hi, size=(256, 1 << p), dtype=np.uint8)
    regs_cols = (rng.integers(lo, hi, size=(384, 1 << p), dtype=np.uint8)
                 if case == "regs_cols" else None)
    vals = screen.bank_values(regs if regs_cols is None
                              else np.concatenate([regs, regs_cols]))
    if case == "truncated":
        vals = screen.truncate_values(vals, 40.0 * (1 << p) / 64, p)
        assert len(vals) < hi - lo
    _k2_compare(cuda, regs, np.array([0, 2, 1, 3, 2], np.int32),
                np.array([0, 1, 0, 2 if regs_cols is not None else 1, 0],
                         np.int32), vals, p, 64, 128, regs_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 7, 8, 9, 10, 14])
@pytest.mark.parametrize("nbins", [1, 2, 3, 5, 13])
@pytest.mark.parametrize("zeros", [True, False])
@pytest.mark.parametrize("sep_cols", [True, False])
def test_k2_matches_plain_bins_and_depths(cuda, p, nbins, zeros, sep_cols):
    """K2 where its walk over the mma depths has edges: a plane padded to
    one depth (p < 8), one, two and four depths a bin (p = 8, 9, 10), a bin
    of many stages (p = 14); bin counts that leave the last stage part
    filled; ti = 192 and tj = 64 (odd multiples of 64, so blocks reach past
    the tile edge); a column bank with another row count; 0 absent (no Z);
    a tile listed twice."""
    lo = 0 if zeros else 2
    rng = np.random.default_rng(1000 * p + 10 * nbins + zeros)
    regs = rng.integers(lo, lo + nbins + 1, size=(384, 1 << p),
                        dtype=np.uint8)
    regs_cols = (rng.integers(lo, lo + nbins + 1, size=(320, 1 << p),
                              dtype=np.uint8) if sep_cols else None)
    vals = screen.bank_values(regs if regs_cols is None
                              else np.concatenate([regs, regs_cols]))
    assert len(vals) == nbins + 1
    _k2_compare(cuda, regs, np.array([0, 1, 1, 0], np.int32),
                np.array([0, 4, 4, 3], np.int32), vals, p, 192, 64,
                regs_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("ti,tj", [(256, 256), (128, 512)])
def test_k2_matches_plain_aux_bank(cuda, ti, tj):
    """K2 on an aux bank of the real register distribution (p_aux=8,
    built from the same hashes as its p=12 primary), truncated as the
    hll-aux screen truncates it."""
    rng = np.random.default_rng(ti + tj)
    regs, aux = synth.synthetic_hll_banks(1024, rng.integers(500, 3000, 1024),
                                          (12, 8), rng)
    synth.plant_near_duplicates(regs, aux, rng, 30)
    vals = screen.truncate_values(screen.bank_values(aux),
                                  host_cards(regs, 12).max(), 8)
    rows, cols = np.triu_indices(1024 // max(ti, tj))
    scale_r, scale_c = max(ti, tj) // ti, max(ti, tj) // tj
    _k2_compare(cuda, aux, (rows * scale_r).astype(np.int32),
                (cols * scale_c).astype(np.int32), vals, 8, ti, tj)


@pytest.mark.cuda
def test_k2_wrapper_rejects_bad_inputs_on_cuda(cuda):
    regs = torch.zeros((128, 256), dtype=torch.uint8, device=cuda)
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    vals = (0, 1, 3)
    with pytest.raises(ValueError, match="uint8"):
        screen.screen_s_z(regs.to(torch.int32), tiles, tiles, 8, vals,
                          ti=64, tj=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        screen.screen_s_z(regs, tiles, tiles, 8, vals, ti=32, tj=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        screen.screen_s_z(regs, tiles, tiles, 8, vals, ti=64, tj=96)
    with pytest.raises(ValueError, match="regs_cols"):
        screen.screen_s_z(regs, tiles, tiles, 8, vals, ti=64, tj=64,
                          regs_cols=torch.zeros((128, 128), dtype=torch.uint8,
                                                device=cuda))
    with pytest.raises(ValueError, match="int32"):
        screen.screen_s_z(regs, tiles.to(torch.int64), tiles, 8, vals,
                          ti=64, tj=64)
    with pytest.raises(ValueError, match="uint8"):
        screen.screen_s_z(regs, tiles, tiles, 8, (0, 300), ti=64, tj=64)


@pytest.mark.cuda
@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
def test_hll_engine_on_cuda_matches_cpu(cuda, crit):
    rng = np.random.default_rng(6)
    regs, aux = synth.synthetic_hll_banks(300, rng.integers(400, 900, 300),
                                          (10, 6), rng)
    synth.plant_near_duplicates(regs, aux, rng, 12)
    bank = SketchBank(names=[f"g{i}" for i in range(300)], regs=regs, p=10,
                      aux_kind="hll", aux=aux, aux_param=6)
    params = SelectionParams(tau=0.5, criterion=crit)
    k1, k2 = screen.screen_hits_fused.launches, screen.screen_s_z.launches
    got = screened.select_pairs_screened(bank, params, ti=128, chunk=4,
                                         device=cuda)
    assert screen.screen_hits_fused.launches > k1
    assert screen.screen_s_z.launches > k2
    want = screened.select_pairs_screened(bank, params, ti=128, chunk=4,
                                          device="cpu")
    assert got == want and len(got) >= 12


def _fasta_corpus(d, rng):
    """Gzipped FASTA files of 20 kbp to 300 kbp with N runs, a near-copy,
    and two FASTQ files of 40-base reads (fewer k-mers than 32 buckets)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    files = []
    seqs = [bases[rng.integers(0, 4, int(n))]
            for n in (300_000, 150_000, 20_000, 60_000)]
    seqs.append(seqs[1].copy())
    seqs[-1][rng.integers(0, seqs[-1].size, 100)] = ord("G")
    for i, seq in enumerate(seqs):
        seq[rng.integers(0, seq.size, 10)] = ord("N")
        path = os.path.join(d, f"g{i}.fna.gz")
        with gzip.open(path, "wb", compresslevel=1) as fh:
            fh.write(b">chr\n" + b"\n".join(
                seq[j:j + 80].tobytes() for j in range(0, seq.size, 80))
                + b"\n")
        files.append(path)
    for q in range(2):
        path = os.path.join(d, f"r{q}.fq")
        read = bases[rng.integers(0, 4, 40)].tobytes()
        with open(path, "wb") as fh:
            fh.write(b"@r\n" + read + b"\n+\n" + b"I" * 40 + b"\n")
        files.append(path)
    return files


@pytest.mark.cuda
@pytest.mark.parametrize("crit,aux_bytes", [
    ("hll_a", 256), ("hll_an", 32), ("smh_a", 256), ("smh_a", 4096)])
def test_build_on_cuda_matches_cpu(cuda, tmp_path, crit, aux_bytes):
    """build_bank_from_files on the card bit-equal to the CPU build, and
    the written sketch files byte-identical: HLL at p = 14 with aux p = 8
    and 2, SMH at m = 32 and 512, packed and chunked genomes, and packs
    whose j=0 pass is incomplete (the full fallback)."""
    files = {}
    for dev in ("cpu", "cuda"):
        os.makedirs(tmp_path / dev)
        files[dev] = _fasta_corpus(str(tmp_path / dev),
                                   np.random.default_rng(aux_bytes))
    stats = {}
    banks = {dev: tbank.build_bank_from_files(
        files[dev], crit, aux_bytes, backend="device",
        device=dev if dev == "cpu" else cuda,
        stats=stats if dev == "cuda" else None) for dev in ("cpu", "cuda")}
    np.testing.assert_array_equal(banks["cuda"].regs, banks["cpu"].regs)
    np.testing.assert_array_equal(banks["cuda"].aux, banks["cpu"].aux)
    if crit == "smh_a":
        assert stats["smh_fallbacks"] >= 1
    if aux_bytes == 4096:
        assert stats["chunked_genomes"] == 3
    for dev in banks:
        banks[dev].write_sketch_files()
    kind, param = tbank.aux_spec(crit, aux_bytes)
    for a, b in zip(files["cuda"], files["cpu"]):
        for sfx in (".hll", f".hll_{param}" if kind == "hll"
                    else f".smh{param}"):
            assert filecmp.cmp(a + sfx, b + sfx, shallow=False)


@pytest.mark.cuda
@pytest.mark.parametrize("crit,aux_bytes", [("smh_a", 256), ("hll_a", 256),
                                            ("hll_an", 512)])
def test_build_native_decoder_on_cuda_matches_cpu_and_native(
        cuda, tmp_path, crit, aux_bytes):
    """The device pipeline on the card fed by the native FASTA reader on 4
    threads gives the CPU build's bank and the native host builder's."""
    assert fastx.available(), fastx.info()["error"]
    files = _fasta_corpus(str(tmp_path), np.random.default_rng(9))
    stats = {}
    got = tbank.build_bank_from_files(files, crit, aux_bytes, io_threads=4,
                                      backend="device", device=cuda,
                                      stats=stats)
    assert (stats["backend"], stats["decoder"], stats["io_threads"]) == (
        "device", "native", 4)
    for want in (tbank.build_bank_from_files(files, crit, aux_bytes,
                                             backend="device", device="cpu"),
                 tbank.build_bank_from_files(files, crit, aux_bytes,
                                             io_threads=4, backend="native")):
        np.testing.assert_array_equal(got.regs, want.regs)
        np.testing.assert_array_equal(got.aux, want.aux)


@pytest.mark.cuda
@pytest.mark.parametrize("aux_kind,aux_param", [("smh", 32), ("smh", 512),
                                                ("hll", 8)])
def test_chunked_sketch_on_cuda_matches_cpu(cuda, aux_kind, aux_param):
    """sketch_codes_device in pieces on the card (k-1 overlap, per-piece
    j=0 pass, unsigned-min merge) equals the CPU result."""
    rng = np.random.default_rng(aux_param)
    codes = np.concatenate([[4], rng.integers(0, 4, 400_000)]).astype(
        np.uint8)
    codes[rng.integers(0, codes.size, 50)] = 4
    got = tbank.sketch_codes_device(codes, 31, 14, aux_kind, aux_param,
                                    device=cuda, max_chunk=100_000)
    want = tbank.sketch_codes_device(codes, 31, 14, aux_kind, aux_param,
                                     device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _dense_bank(crit):
    rng = np.random.default_rng(7)
    if crit.startswith("hll"):
        regs, aux = synth.synthetic_hll_banks(
            200, rng.integers(400, 900, 200), (10, 6), rng)
        kind, param = "hll", 6
    else:
        regs = synth.synthetic_regs(200, rng.integers(400, 900, 200), 10,
                                    rng)
        aux = synth.synthetic_aux(200, 16, rng)
        kind, param = "smh", 16
    synth.plant_near_duplicates(regs, aux, rng, 12)
    return SketchBank(names=[f"g{i}" for i in range(200)], regs=regs, p=10,
                      aux_kind=kind, aux=aux, aux_param=param)


@pytest.mark.cuda
@pytest.mark.parametrize("crit", ["smh_a", "smh_only", "cb", "baseline",
                                  "hll_a", "hll_an"])
def test_dense_engine_on_cuda_matches_cpu(cuda, crit):
    """The dense engine on the card (f32 MLE, device confirm histograms)
    prints the CPU run's lines (f64 MLE, host histograms), with a block
    that does not divide N."""
    bank = _dense_bank(crit)
    params = SelectionParams(tau=0.5, criterion=crit, engine="dense",
                             block=48)
    got = select_pairs(bank, params, device=cuda)
    assert got == select_pairs(bank, params, device="cpu")
    assert len(got) >= 12


@pytest.mark.cuda
@pytest.mark.parametrize("bi,bj,p", [(8, 9, 8), (16, 17, 8), (17, 24, 10),
                                     (512, 512, 14), (13, 11, 6)])
def test_dense_routes_give_equal_histograms_on_cuda(cuda, bi, bj, p):
    """torch._int_mm (int8) and the f32 matmul route give the same union
    histograms on the card, equal to the CPU's, including the row counts
    that torch._int_mm's shape limits make the wrapper pad."""
    rng = np.random.default_rng(bi + bj + p)
    a = rng.integers(0, 64 - p + 2, size=(bi, 1 << p), dtype=np.uint8)
    b = rng.integers(0, 64 - p + 2, size=(bj, 1 << p), dtype=np.uint8)
    want = pairwise.union_histograms(torch.from_numpy(a),
                                     torch.from_numpy(b), p, "int8")
    for precision in ("int8", "bf16"):
        got = pairwise.union_histograms(torch.from_numpy(a).to(cuda),
                                        torch.from_numpy(b).to(cuda), p,
                                        precision)
        assert torch.equal(got.cpu(), want)


def _mle_histograms(p, n, seed, log1p_branch):
    """Histograms of pair unions of synthetic register rows. With
    log1p_branch: registers only at q-1, q and q+1 instead, mostly q+1 -
    the only histograms whose secant start takes its log1p branch (g0 >
    1.5a needs no zero register and almost no weight below q)."""
    rng = np.random.default_rng(seed)
    if log1p_branch:
        q, m = 64 - p, 1 << p
        c = np.zeros((n, 64), np.int64)
        c[:, q] = rng.integers(1, m // 3, n)
        c[:, q - 1] = rng.integers(0, 3, n)
        c[:, q + 1] = m - c[:, q] - c[:, q - 1]
        return c
    regs = synth.synthetic_regs(256, rng.integers(50, 200_000, 256), p, rng)
    ii, kk = rng.integers(0, 256, size=(2, n))
    return hostref.pair_union_histograms_np(regs, ii, kk)


def _ulps(a, b):
    """|a - b| in units in the last place of f64 (positive finite values;
    equal infinities count 0)."""
    same = (a == b)
    ai, bi = a.view(np.int64), b.view(np.int64)
    return np.where(same, 0, np.abs(ai - bi))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 14])
def test_ertl_mle_f64_on_cuda_vs_host(cuda, p):
    """The card's f64 ERTL-MLE against hostref.ertl_mle_batch: bit-equal
    on pair unions of realistic register rows, whose secant start never
    calls log1p. Histograms that do (no register below q-1) get 4 ulp: a
    1-ulp log1p difference moves the secant's result by up to 3 ulp, as
    the JAX package's own f64 MLE (XLA's log1p) and torch's on the CPU
    show against glibc's (tests/test_torch_dense.py)."""
    for log1p_branch in (False, True):
        hists = _mle_histograms(p, 4096, p + log1p_branch, log1p_branch)
        want = hostref.ertl_mle_batch(hists, p)
        got = estimators.ertl_mle(torch.from_numpy(hists).to(cuda),
                                  p).cpu().numpy()
        ulps = _ulps(got, want)
        if log1p_branch:
            assert ulps.max() <= 4
        else:
            assert ulps.max() == 0
        f32 = estimators.ertl_mle(torch.from_numpy(hists).to(cuda), p,
                                  dtype=torch.float32).cpu().numpy()
        fin = np.isfinite(want) & (want > 0)
        assert np.abs(f32[fin] / want[fin] - 1.0).max() <= 1e-5


@pytest.mark.cuda
def test_scalar_divisor_on_cuda(cuda):
    """Regression case for x_pp / 3 in the MLE's secant start: a CUDA
    tensor divided by a CPU scalar is multiplied by the scalar's
    reciprocal, so the MLE divides by a device tensor; that division is
    C's `/`, bit for bit, where the reciprocal product is not."""
    rng = np.random.default_rng(3)
    x = rng.uniform(1e-6, 1.0, 1 << 16) ** 2
    recip = x * (1.0 / 3.0)
    assert np.any(recip != x / 3)  # the inputs exercise the difference
    got = torch.from_numpy(x).to(cuda) / torch.tensor(3.0, dtype=torch.float64,
                                                      device=cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), x / 3)
    # and the whole MLE: histograms whose secant starts differ between
    # the two forms give the CPU's estimates on the card
    hists = _mle_histograms(14, 2048, 5, False)
    np.testing.assert_array_equal(
        estimators.ertl_mle(torch.from_numpy(hists).to(cuda), 14).cpu()
        .numpy(), estimators.ertl_mle(torch.from_numpy(hists), 14).numpy())


# Strip cases of K1 (the ring's screen step): a row strip of 192 rows and a
# column strip of 256, distinct banks, with (row_base, col_base) putting the
# column strip after, level with and before the row strip, and the triangle's
# edge inside a 128-edge block.
STRIP_BASES = {"below": (0, 192), "equal": (64, 64), "above": (256, 192),
               "edge_in_block": (96, 64)}
STRIP_TILES = (np.array([0, 1, 2, 0, 2], np.int32),
               np.array([0, 3, 1, 2, 3], np.int32))


def _strip_inputs(seed, lo, n_r=192, n_c=256, p=8):
    """(regs, e, fp) of an n_r-row strip and an n_c-row strip, with rows of
    the column strip that copy rows (and fingerprints) of the row strip."""
    regs_r, e_r, fp_r = _inputs(seed, lo, 11, n_r, p)
    regs_c, e_c, fp_c = _inputs(seed + 1, lo, 11, n_c, p)
    for r, c in ((7, 5), (70, 130), (150, 250), (100, 64)):
        regs_c[c], fp_c[c], e_c[c] = regs_r[r], fp_r[r], e_r[r]
    return (regs_r, e_r, fp_r), (regs_c, e_c, fp_c)


def _strip_compare(dev, rows_side, cols_side, bases, n_real, vals, p, ti,
                   use_cb, use_smh, tau_scr=0.4, tau_cb=0.35,
                   tiles=STRIP_TILES):
    (regs_r, e_r, fp_r), (regs_c, e_c, fp_c) = [
        [torch.from_numpy(np.asarray(x)).to(dev) for x in side]
        for side in (rows_side, cols_side)]
    r_t, c_t = [torch.from_numpy(x).to(dev) for x in tiles]
    args = (regs_r, regs_c, r_t, c_t, e_r, e_c, fp_r, fp_c, *bases, n_real,
            tau_scr, tau_cb, p, vals, ti, fp_r.shape[1], use_cb, use_smh)
    before = screen.screen_hits_fused_strips.launches
    got = screen.screen_hits_fused_strips(*args)
    want = screen._screen_hits_fused_strips_plain(*args)
    torch.cuda.synchronize()
    assert screen.screen_hits_fused_strips.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return int(got[1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("bases", list(STRIP_BASES))
@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True), (False, False),
])
@pytest.mark.parametrize("with_zeros", [True, False])
def test_strip_kernel_matches_plain(cuda, bases, use_cb, use_smh,
                                    with_zeros):
    """K1's strip variant against its plain version, bit-equal: local ids
    index each strip's bank, e and fp; the triangle and n_real (inside the
    column strip) take global ids."""
    rows_side, cols_side = _strip_inputs(200 + use_cb + 2 * use_smh,
                                         0 if with_zeros else 2)
    vals = screen.bank_values(np.concatenate([rows_side[0], cols_side[0]]))
    row_base, col_base = STRIP_BASES[bases]
    _strip_compare(cuda, rows_side, cols_side, (row_base, col_base),
                   col_base + 150, vals, 8, 64, use_cb, use_smh)


@pytest.mark.cuda
@pytest.mark.parametrize("bases", list(STRIP_BASES))
def test_strip_kernel_edge_inside_blocks(cuda, bases):
    """ti = 128 (one block a tile) with every cardinality large, so the
    triangle and the tail alone decide which pairs pass: the hits stop at
    the global triangle's edge inside the block."""
    rows_side, cols_side = _strip_inputs(230, 0, 256, 384)
    for side in (rows_side, cols_side):
        side[1][:] = 1.0e6
    vals = screen.bank_values(np.concatenate([rows_side[0], cols_side[0]]))
    hits = _strip_compare(cuda, rows_side, cols_side, STRIP_BASES[bases],
                          STRIP_BASES[bases][1] + 200, vals, 8, 128, True,
                          False, tau_scr=0.9,
                          tiles=(np.array([0, 0], np.int32),
                                 np.array([0, 1], np.int32)))
    assert hits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_cb,use_smh", [(True, True), (False, False)])
def test_single_bank_through_strip_entry(cuda, use_cb, use_smh):
    """The single-bank K1 cases through the strip entry point (both sides
    the same tensors, bases 0): bit-equal to screen_hits_fused and to the
    plain version."""
    regs, e, fp = _inputs(31 + use_cb + 2 * use_smh, 0, 11, 192, 8)
    t = [torch.from_numpy(x).to(cuda) for x in (regs, e, fp)]
    rows = torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=cuda)
    cols = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device=cuda)
    vals = screen.bank_values(regs)
    kw = dict(n_real=187, tau_scr=0.4, tau_cb=0.35, p=8, values=vals, ti=64,
              n_bands=4, use_cb=use_cb, use_smh=use_smh)
    got = screen.screen_hits_fused_strips(t[0], t[0], rows, cols, t[1], t[1],
                                          t[2], t[2], 0, 0, **kw)
    one = screen.screen_hits_fused(t[0], rows, cols, t[1], t[2], **kw)
    want = screen._screen_hits_fused_plain(t[0], rows, cols, t[1], t[2],
                                           **kw)
    for g, o, w in zip(got, one, want):
        assert torch.equal(g, o) and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_r,n_c", [(128, 256), (256, 128)])
def test_strip_views_of_one_bank(cuda, n_r, n_c):
    """Two views of one bank that start at the same address but hold
    different row counts are two strips: the column view gets its own
    planes (the kernel packs a second bank whenever the wrapper hands it a
    second scratch), so column tiles past the row view read its rows."""
    regs, e, fp = _inputs(240, 0, 11, 256, 8)
    bank = [torch.from_numpy(x).to(cuda) for x in (regs, e, fp)]
    short, long_ = [0, 1, 0], [2, 3, 3]
    rows, cols = [torch.tensor(t, dtype=torch.int32, device=cuda) for t in (
        (short, long_) if n_r < n_c else (long_, short))]
    r_side = [x[:n_r] for x in bank]
    c_side = [x[:n_c] for x in bank]
    assert r_side[0].data_ptr() == c_side[0].data_ptr()
    # the column strip placed after the row strip: every pair is i < j
    args = (r_side[0], c_side[0], rows, cols, r_side[1], c_side[1],
            r_side[2], c_side[2], 0, n_r, n_r + n_c, 0.4, 0.35, 8,
            screen.bank_values(regs), 64, 4, True, True)
    got = screen.screen_hits_fused_strips(*args)
    want = screen._screen_hits_fused_strips_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1][1]) > 0  # tiles 1 and 3: one side past row 128


@pytest.mark.cuda
def test_ring_wave_bounds_device_memory_on_cuda(cuda):
    """The ring's counts are read every `wave` chunks: on four virtual
    devices of the card, what the allocator holds at a read beyond the
    step loop's start stays within the four positions' masks (plus counts
    and tile ids), and the lines are the CPU mesh's."""
    from cuda_selection_criteria_tpu_torch.parallel import mesh, ring

    bank = _engine_bank("cb")
    params = SelectionParams(tau=0.5, criterion="cb")
    stats = {}
    got = ring.select_pairs_ring(bank, params, mesh=mesh.row_mesh([cuda] * 4),
                                 ti=64, chunk_tiles=2, stats=stats, wave=1)
    want = ring.select_pairs_ring(bank, params,
                                  mesh=mesh.row_mesh(["cpu"] * 4), ti=64,
                                  chunk_tiles=2, wave=1)
    assert got == want and len(got) >= 12
    masks = 4 * 2 * 64 * 64
    assert 0 < stats["max_device_mask_bytes"] <= 2 * 64 * 64
    assert 0 < stats["max_wave_alloc_bytes"] <= masks + (1 << 20)


def _engine_bank(crit, n=300):
    rng = np.random.default_rng(8)
    if crit.startswith("hll"):
        regs, aux = synth.synthetic_hll_banks(n, rng.integers(400, 900, n),
                                              (10, 6), rng)
        synth.plant_near_duplicates(regs, aux, rng, 12)
        return SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=10,
                          aux_kind="hll", aux=aux, aux_param=6)
    regs = synth.synthetic_regs(n, rng.integers(400, 900, n), 10, rng)
    aux = synth.synthetic_aux(n, 16, rng)
    synth.plant_near_duplicates(regs, aux, rng, 12)
    return SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=10,
                      aux_kind="smh", aux=aux, aux_param=16)


@pytest.mark.cuda
@pytest.mark.parametrize("crit", ["smh_a", "cb", "hll_a"])
def test_multi_device_engines_on_cuda_match_cpu(cuda, crit):
    """The ring (K1's strip variant, four virtual devices of one card, so
    strips with non-zero bases), the tile-sharded engine and the dense mesh
    on the card, each equal to the same engine on CPU devices."""
    from cuda_selection_criteria_tpu_torch.parallel import mesh, ring

    bank = _engine_bank(crit)
    params = SelectionParams(tau=0.5, criterion=crit)
    strips = screen.screen_hits_fused_strips.launches
    runs = []
    for dev in (cuda, torch.device("cpu")):
        runs.append((
            ring.select_pairs_ring(bank, params, mesh=mesh.row_mesh([dev] * 4),
                                   ti=64, chunk_tiles=4),
            screened.select_pairs_screened_sharded(
                bank, params, mesh=mesh.row_mesh([dev] * 4), ti=128,
                chunk=4),
            mesh.select_pairs_sharded(bank, params,
                                      mesh=mesh.make_mesh(2, 2, [dev] * 4))))
    assert screen.screen_hits_fused_strips.launches > strips
    assert runs[0] == runs[1]
    assert runs[0][0] == runs[0][1] == runs[0][2] and len(runs[0][0]) >= 12


@pytest.mark.cuda
@pytest.mark.parametrize("slab_rows", [3, 1000])
def test_upload_sorted_rows_on_cuda_bytes(cuda, slab_rows):
    """The slab-pipelined upload with pinned arenas and non_blocking
    copies: slabs far smaller than the bank (a refill of an arena before
    its copy has finished would corrupt rows), the bank's bytes equal to
    the host's sorted rows, zero-padded; the result is on the card and
    the stats count every slab."""
    rng = np.random.default_rng(17)
    regs = rng.integers(0, 256, size=(4099, 1 << 14), dtype=np.uint8)
    order = rng.permutation(len(regs))
    stats = {}
    got = screened.upload_sorted_rows(regs, order, 0, 5120, cuda,
                                      slab_bytes=slab_rows << 14,
                                      stats=stats)
    assert got.device.type == "cuda" and got.shape == (5120, 1 << 14)
    assert stats["slabs"] == -(-len(regs) // slab_rows)
    host = got.cpu().numpy()
    np.testing.assert_array_equal(host[:len(regs)], regs[order])
    assert not host[len(regs):].any()
    part = screened.upload_sorted_rows(regs, order, 1000, 2048, cuda,
                                       slab_bytes=slab_rows << 14)
    np.testing.assert_array_equal(part.cpu().numpy(), regs[order[1000:3048]])


@pytest.mark.cuda
def test_plan_stage_peak_within_bank_and_half_a_gib(cuda):
    """ScreenPlan.__init__ on the N=65,536 bench bank (1 GiB of registers)
    holds the padded bank and at most 0.5 GiB more on the card (the
    upload's slabs live on the host), and its device bank is the host's
    sorted rows."""
    regs, aux, e = synth.bench_bank(65536)
    bank = SketchBank(names=[f"g{i}" for i in range(len(regs))], regs=regs,
                      p=14, cards=e, aux_kind="smh", aux=aux, aux_param=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.9), 1024,
                               device=cuda)
    peak = torch.cuda.max_memory_allocated() - before
    assert plan.d_regs.nbytes == plan.n_pad << 14
    assert peak <= plan.d_regs.nbytes + (1 << 29)
    assert plan.upload_stats["slabs"] == 8
    np.testing.assert_array_equal(plan.d_regs[:4096].cpu().numpy(),
                                  regs[plan.order[:4096]])
    np.testing.assert_array_equal(plan.d_regs[-4096:].cpu().numpy(),
                                  regs[plan.order[-4096:]])


@pytest.mark.cuda
def test_k2_p14_ti1024_matches_plain(cuda):
    """K2 at the bench's raw width (p=14, ti = tj = 1024) on 8 tiles of the
    sorted bench bank, bit-equal to its plain version."""
    regs, _, e = synth.bench_bank(4096)
    order = np.argsort(e, kind="stable")
    d_regs = torch.from_numpy(regs[order]).to(cuda)
    values = screen.truncate_values(screen.bank_values(d_regs),
                                    float(e.max()), 14)
    rows = torch.tensor([0, 0, 1, 3, 2, 1, 3, 0], dtype=torch.int32,
                        device=cuda)
    cols = torch.tensor([0, 3, 1, 3, 2, 2, 0, 1], dtype=torch.int32,
                        device=cuda)
    before = screen.screen_s_z.launches
    s, z = screen.screen_s_z(d_regs, rows, cols, 14, values, ti=1024,
                             tj=1024)
    ws, wz = screen._screen_s_z_plain(d_regs, rows, cols, 14, values, 1024,
                                      1024)
    torch.cuda.synchronize()
    assert screen.screen_s_z.launches == before + 1
    assert torch.equal(s, ws)
    assert (z is None) == (wz is None)
    if z is not None:
        assert torch.equal(z, wz)


GATE_ARRAYS = ("e_rows", "e_cols", "fp_rows", "fp_cols", "row_tiles",
               "col_tiles")


def _gate_compare(dev, case, use_cb, use_smh):
    """The gate-count kernel against its plain version on the card,
    bit-equal, on a tests/gate_cases.py case; returns the counts."""
    t = {k: torch.from_numpy(case[k]).to(dev) for k in GATE_ARRAYS}
    args = (t["e_rows"], t["e_cols"], t["fp_rows"], t["fp_cols"],
            t["row_tiles"], t["col_tiles"], case["row_base"],
            case["col_base"], case["n_real"], case["tau_cb"],
            case["n_bands"], case["ti"], use_cb, use_smh)
    before = screen.gate_counts.launches
    got = screen.gate_counts(*args)
    want = screen._gate_counts_plain(*args)
    torch.cuda.synchronize()
    assert screen.gate_counts.launches == before + 1
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("use_cb,use_smh", gate_cases.GATES)
@pytest.mark.parametrize("n_bands", gate_cases.BANDS + (2, 3, 64))
def test_gate_kernel_bank_matches_plain(cuda, n_bands, use_cb, use_smh):
    """One bank with n_real inside a tile, empty columns, CB ties and tiles
    below the diagonal; 1 to 32 bands in registers, 3 and 64 read from
    memory."""
    got = _gate_compare(cuda, gate_cases.bank_case(40 + n_bands, n_bands),
                        use_cb, use_smh)
    assert got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("use_cb,use_smh", gate_cases.GATES)
@pytest.mark.parametrize("where", list(gate_cases.STRIP_BASES))
def test_gate_kernel_strips_match_plain(cuda, where, use_cb, use_smh):
    """Strips before, level with and after each other, the triangle's edge
    inside a tile, n_real inside the column strip."""
    _gate_compare(cuda, gate_cases.strip_case(
        60 + len(where), gate_cases.STRIP_BASES[where]), use_cb, use_smh)


@pytest.mark.cuda
@pytest.mark.parametrize("ti", [130, 300, 1024])
@pytest.mark.parametrize("bases", [(0, 0), (140, 100), (0, 300)])
def test_gate_kernel_ragged_tiles_match_plain(cuda, ti, bases):
    """Tiles that are no multiple of the kernel's 128-row CTAs and
    256-column stages, every gate combination."""
    case = gate_cases.ragged_case(ti + bases[0], ti, bases=bases)
    for use_cb, use_smh in gate_cases.GATES:
        _gate_compare(cuda, case, use_cb, use_smh)


@pytest.mark.cuda
def test_gate_kernel_masks_strip_edges(cuda):
    """Tiles that run past the strips' ends count what the plain version
    counts on strips padded with rows and columns that pass no gate."""
    case = gate_cases.ragged_case(11, 300, bases=(40, 0))
    cut, padded = gate_cases.cut_strips(case, 700, 830)
    for use_cb, use_smh in gate_cases.GATES[:3]:
        t = {k: torch.from_numpy(cut[k]).to(cuda) for k in GATE_ARRAYS}
        got = screen.gate_counts(
            t["e_rows"], t["e_cols"], t["fp_rows"], t["fp_cols"],
            t["row_tiles"], t["col_tiles"], cut["row_base"],
            cut["col_base"], cut["n_real"], cut["tau_cb"], cut["n_bands"],
            cut["ti"], use_cb, use_smh)
        want = _gate_compare(cuda, padded, use_cb, use_smh)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_gate_kernel_rejects_mixed_devices(cuda):
    case = gate_cases.bank_case(5, 4, ti=16, n_tiles=2)
    t = {k: torch.from_numpy(case[k]).to(cuda) for k in GATE_ARRAYS}
    with pytest.raises(ValueError, match="gate_counts"):
        screen.gate_counts(
            t["e_rows"], t["e_cols"].cpu(), t["fp_rows"], t["fp_cols"],
            t["row_tiles"], t["col_tiles"], 0, 0, case["n_real"],
            case["tau_cb"], 4, 16, True, True)
