"""The port's CUDA kernels (K1 screen_fused with its launch's plane
scratch and the plan's row map, K2 weighted_cdf_sum, the gate prune's
gate_counts, value_presence, the plan's row_hist, the ERTL-MLE
ertl_mle, the plan's band fingerprints band_fp, the packed upload's
regpack_unpack) and their card paths, and the reference's own kernel
(experiments/reference_kernel.cu, a measured baseline)
against their plain versions,
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
import functools
import gzip
import os

import numpy as np
import pytest
import torch

import band_fp_cases
import gate_cases

from cuda_selection_criteria_tpu_torch.experiments import reference_kernel
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.ops import (criteria, estimators,
                                                  pairwise, regpack, screen)
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
    regs_t, e_t, fp_t = [torch.from_numpy(np.asarray(x)).to(dev)
                         for x in (regs, e, fp)]
    tiles = screen.launch_tiles(rows, cols, True, dev)
    n_real = regs.shape[0] - 5 if n_real is None else n_real
    kw = dict(n_real=n_real, tau_scr=tau_scr, tau_cb=tau_cb, p=p,
              values=vals, ti=ti, n_bands=fp.shape[1], use_cb=use_cb,
              use_smh=use_smh)
    before = screen.screen_hits_fused.launches
    got = screen.screen_hits_fused(regs_t, tiles, e_t, fp_t, **kw)
    want = screen._screen_hits_fused_plain(regs_t, tiles.row_tiles,
                                           tiles.col_tiles, e_t, fp_t, **kw)
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
    tiles = screen.launch_tiles([0], [0], True, cuda)
    with pytest.raises(ValueError, match="uint8"):
        screen.screen_hits_fused(
            regs, tiles, torch.zeros(128, device=cuda),
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
    lt = screen.launch_tiles(*tiles, False, dev)
    rest = (e_r, e_c, fp_r, fp_c, *bases, n_real, tau_scr, tau_cb, p, vals,
            ti, fp_r.shape[1], use_cb, use_smh)
    before = screen.screen_hits_fused_strips.launches
    got = screen.screen_hits_fused_strips(regs_r, regs_c, lt, *rest)
    want = screen._screen_hits_fused_strips_plain(
        regs_r, regs_c, lt.row_tiles, lt.col_tiles, *rest)
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
    tiles = screen.launch_tiles([0, 0, 1, 2], [0, 2, 1, 2], True, cuda)
    vals = screen.bank_values(regs)
    kw = dict(n_real=187, tau_scr=0.4, tau_cb=0.35, p=8, values=vals, ti=64,
              n_bands=4, use_cb=use_cb, use_smh=use_smh)
    got = screen.screen_hits_fused_strips(t[0], t[0], tiles, t[1], t[1],
                                          t[2], t[2], 0, 0, **kw)
    one = screen.screen_hits_fused(t[0], tiles, t[1], t[2], **kw)
    want = screen._screen_hits_fused_plain(t[0], tiles.row_tiles,
                                           tiles.col_tiles, t[1], t[2], **kw)
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
    tiles = screen.launch_tiles(
        *((short, long_) if n_r < n_c else (long_, short)), False, cuda)
    r_side = [x[:n_r] for x in bank]
    c_side = [x[:n_c] for x in bank]
    assert r_side[0].data_ptr() == c_side[0].data_ptr()
    # the column strip placed after the row strip: every pair is i < j
    rest = (r_side[1], c_side[1], r_side[2], c_side[2], 0, n_r, n_r + n_c,
            0.4, 0.35, 8, screen.bank_values(regs), 64, 4, True, True)
    got = screen.screen_hits_fused_strips(r_side[0], c_side[0], tiles, *rest)
    want = screen._screen_hits_fused_strips_plain(
        r_side[0], c_side[0], tiles.row_tiles, tiles.col_tiles, *rest)
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
    holds its bank and at most 0.5 GiB more on the card (the upload's
    slabs live on the host; the row histograms, 16 MiB, die in the plan),
    its device bank is the host's rows in their own order and one zero
    row, and read through the plan's row map it is the sorted rows."""
    regs, aux, e = synth.bench_bank(65536)
    bank = SketchBank(names=[f"g{i}" for i in range(len(regs))], regs=regs,
                      p=14, cards=e, aux_kind="smh", aux=aux, aux_param=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.9), 1024,
                               device=cuda)
    peak = torch.cuda.max_memory_allocated() - before
    assert plan.d_bank.nbytes == (plan.n + 1) << 14
    assert peak <= plan.d_bank.nbytes + (1 << 29)
    assert plan.upload_stats["slabs"] == 8
    np.testing.assert_array_equal(plan.d_bank[:4096].cpu().numpy(),
                                  regs[:4096])
    assert not plan.d_bank[-1].any()
    rows = plan.d_rows.long()
    np.testing.assert_array_equal(plan.d_bank[rows[:4096]].cpu().numpy(),
                                  regs[plan.order[:4096]])
    np.testing.assert_array_equal(plan.d_bank[rows[-4096:]].cpu().numpy(),
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


# The presence kernel (csrc/value_presence.cu, the plan's bank_values): the
# bytes as HLL banks, aux banks, uniform bytes with a ragged tail, one
# value, large values only in the head or the tail, a prefix of a
# zero-padded bank, and a bank of many blocks' grid-stride loop.
def _presence_bytes(name):
    rng = np.random.default_rng(len(name))
    if name in ("hll p=14", "aux p_aux=8"):
        p = 14 if name == "hll p=14" else 8
        n = 8 if p == 14 else 300
        return synth.synthetic_hll_banks(
            n, rng.integers(64, 60000, n), (p,), rng)[0].reshape(-1)
    if name == "uniform 0-255, ragged":
        return rng.integers(0, 256, 16 * 1000 + 13, dtype=np.uint8)
    if name == "one value":
        return np.full(4099, 7, np.uint8)
    if name in ("64 first", "255 last"):
        x = rng.integers(0, 52, 16 * 77 + 9, dtype=np.uint8)
        x[0 if name == "64 first" else -1] = int(name.split()[0])
        return x
    if name == "prefix of a padded bank":
        x = np.zeros((96, 1024), np.uint8)
        x[:64] = rng.integers(1, 30, size=(64, 1024), dtype=np.uint8)
        return x.reshape(-1)[:64 * 1024]
    x = rng.integers(0, 52, (1 << 26) + 13, dtype=np.uint8)  # many blocks
    x[-3] = 200
    return x


PRESENCE_CASES = ("hll p=14", "aux p_aux=8", "uniform 0-255, ragged",
                  "one value", "64 first", "255 last",
                  "prefix of a padded bank", "64 MiB + 13")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PRESENCE_CASES)
@pytest.mark.parametrize("offset", [0, 1, 15])
def test_presence_kernel_matches_plain(cuda, name, offset):
    """bank_values on a CUDA tensor launches the kernel once and gives the
    plain version's values (on the same card tensor and on the host), the
    start at every alignment class that moves the head."""
    x = _presence_bytes(name)[offset:]
    d = torch.from_numpy(x).to(cuda)
    before = screen.bank_values.launches
    got = screen.bank_values(d)
    torch.cuda.synchronize()
    assert screen.bank_values.launches == before + 1
    assert got == screen._bank_values_plain(d, 1 << 24) == \
        screen.bank_values(x)
    if name == "uniform 0-255, ragged":
        assert got == tuple(range(256))


@pytest.mark.cuda
def test_presence_kernel_empty_and_2d(cuda):
    """No bytes: no launch, no values; a 2-D bank and its row prefix."""
    before = screen.bank_values.launches
    assert screen.bank_values(torch.zeros(0, dtype=torch.uint8,
                                          device=cuda)) == ()
    assert screen.bank_values.launches == before
    regs = np.zeros((8, 64), np.uint8)
    regs[:5] = np.arange(5 * 64).reshape(5, 64) % 61 + 1
    d = torch.from_numpy(regs).to(cuda)
    assert screen.bank_values(d[:5]) == tuple(range(1, 62))
    assert screen.bank_values(d) == tuple(range(0, 62))
    with pytest.raises(ValueError, match="contiguous"):
        screen.bank_values(d.t())


# K1 with the plane scratch of its launch's blocks: 6 blocks of 64 rows,
# tiles that touch the first and the last block, repeat blocks, sit on the
# diagonal or scatter.
K1_BLOCK_TILES = {
    "first and last": ([0, 0, 5], [5, 0, 5]),
    "repeated": ([2, 2, 2, 3, 3], [3, 3, 2, 3, 3]),
    "diagonal": ([0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5]),
    "scattered": ([1, 4], [4, 5]),
}


def _launch_peak(fn):
    """(fn(), device bytes allocated at the peak of fn beyond before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _scratch_bytes(tiles, ti, nbins, p):
    """K1's plane scratch of a launch: its distinct blocks, once a side (a
    shared list once in all), ti rows of nbins planes of plane_words(p)
    uint32 words each."""
    n_blocks = tiles.row_blocks.numel() + (
        0 if tiles.col_blocks is tiles.row_blocks
        else tiles.col_blocks.numel())
    return n_blocks * ti * nbins * screen.plane_words(p) * 4


def _held_to_scratch(peak, scratch, hits):
    """A launch holds its plane scratch, its hits and its counts (one
    512-byte allocator block) beyond what it was given: less than one more
    block of planes (ti * nbins * plane_words(p) * 4 >= 8 KiB here)."""
    assert scratch <= peak <= scratch + hits.nbytes + 4096


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(K1_BLOCK_TILES))
def test_k1_launch_blocks_match_plain(cuda, label):
    """Bit-equal hits and counts; the plane scratch holds the launch's
    distinct blocks once: n_blocks * ti * nbins * plane_words(p) * 4
    bytes, all the launch holds beyond its hits and counts."""
    regs, e, fp = _inputs(300 + len(label), 0, 12, 384, 8)
    rows, cols = K1_BLOCK_TILES[label]
    vals = screen.bank_values(regs)
    t = [torch.from_numpy(x).to(cuda) for x in (regs, e, fp)]
    tiles = screen.launch_tiles(rows, cols, True, cuda)
    kw = dict(n_real=380, tau_scr=0.4, tau_cb=0.35, p=8, values=vals, ti=64,
              n_bands=4, use_cb=True, use_smh=True)
    screen.screen_hits_fused(t[0], tiles, t[1], t[2], **kw)  # warm-up
    got, peak = _launch_peak(lambda: screen.screen_hits_fused(
        t[0], tiles, t[1], t[2], **kw))
    want = screen._screen_hits_fused_plain(t[0], tiles.row_tiles,
                                           tiles.col_tiles, t[1], t[2], **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 0
    scratch = _scratch_bytes(tiles, 64, len(vals) - 1, 8)
    assert scratch == (len(np.unique(rows + cols)) * 64 * (len(vals) - 1)
                       * screen.plane_words(8) * 4)
    _held_to_scratch(peak, scratch, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["first and last", "repeated", "one tile"])
def test_k1_strip_launch_blocks_match_plain(cuda, label):
    """The strip entry with one block list a side (a 192-row row strip, a
    256-row column strip: first and last blocks of each, repeats): bit-equal
    to its plain version, scratch of both sides' blocks."""
    rows, cols = {"first and last": ([0, 2, 2, 0], [3, 0, 3, 3]),
                  "repeated": ([1, 1, 1], [2, 2, 2]),
                  "one tile": ([2], [0])}[label]
    rows_side, cols_side = _strip_inputs(330 + len(label), 0)
    vals = screen.bank_values(np.concatenate([rows_side[0], cols_side[0]]))
    (regs_r, e_r, fp_r), (regs_c, e_c, fp_c) = [
        [torch.from_numpy(x).to(cuda) for x in side]
        for side in (rows_side, cols_side)]
    tiles = screen.launch_tiles(rows, cols, False, cuda)
    rest = (e_r, e_c, fp_r, fp_c, 64, 64, 300, 0.4, 0.35, 8, vals, 64, 4,
            True, True)
    screen.screen_hits_fused_strips(regs_r, regs_c, tiles, *rest)  # warm-up
    got, peak = _launch_peak(lambda: screen.screen_hits_fused_strips(
        regs_r, regs_c, tiles, *rest))
    want = screen._screen_hits_fused_strips_plain(
        regs_r, regs_c, tiles.row_tiles, tiles.col_tiles, *rest)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    scratch = _scratch_bytes(tiles, 64, len(vals) - 1, 8)
    assert scratch == ((len(set(rows)) + len(set(cols))) * 64
                       * (len(vals) - 1) * screen.plane_words(8) * 4)
    _held_to_scratch(peak, scratch, got[0])


@pytest.mark.cuda
def test_k1_engine_launches_read_their_blocks(cuda):
    """The screened engine on the card passes each launch's blocks: a
    chunk's scratch is its tiles' distinct blocks, not the bank."""
    rng = np.random.default_rng(12)
    regs = synth.synthetic_regs(640, rng.integers(400, 900, 640), 10, rng)
    aux = synth.synthetic_aux(640, 16, rng)
    synth.plant_near_duplicates(regs, aux, rng, 12)
    bank = SketchBank(names=[f"g{i}" for i in range(640)], regs=regs, p=10,
                      aux_kind="smh", aux=aux, aux_param=16)
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.5), 64,
                               device=cuda)
    rows, cols = np.array([0, 0, 3], np.int32), np.array([0, 9, 3], np.int32)
    plan.screen_chunk(rows, cols)  # warm-up
    (hits, counts), peak = _launch_peak(lambda: plan.screen_chunk(rows,
                                                                  cols))
    want = screened.ScreenPlan(bank, SelectionParams(tau=0.5), 64,
                               device="cpu").screen_chunk(rows, cols)
    assert torch.equal(hits.cpu(), want[0]) and torch.equal(counts.cpu(),
                                                           want[1])
    block = 64 * (len(plan.values) - 1) * screen.plane_words(10) * 4
    assert 3 * block <= peak < 10 * block  # blocks 0, 3, 9 of the bank's 10


# The row-histogram kernel: skewed HLL rows at p = 14 with all-zero rows
# and the HLL maximum; rows of 100 and 48 registers (not 16 bytes a lane,
# each row at another alignment); row counts that are not a multiple of the
# CTA's 4 rows; a start one byte into a buffer; uniform values 0..63; dense
# rows of real-sized genomes at p = 14 (no zero byte); rows of one value,
# every value 0..63 (a lane's counts all on one counter).
def _hll_like(rng, n, r, top=51):
    hit = rng.random((n, r)) < 0.12
    return np.where(hit, np.minimum(rng.geometric(0.5, (n, r)), top),
                    0).astype(np.uint8)


def _dense_like(rng, n, r, p=14):
    lam = np.exp(rng.uniform(np.log(2.0 ** 20), np.log(2.0 ** 24),
                             (n, 1))) / (1 << p)
    e = rng.exponential(size=(n, r))
    return np.clip(np.ceil(np.log2(lam / e)), 0, 64 - p + 1).astype(np.uint8)


def _row_hist_bank(name):
    rng = np.random.default_rng(len(name) + 7)
    if name == "p=14 skewed, zero rows":
        x = _hll_like(rng, 203, 1 << 14)
        x[[0, 101, 202]] = 0
        x[5, 77] = 51
        return x, 0
    if name == "R=100":
        return _hll_like(rng, 13, 100), 0
    if name == "R=48 uniform":
        return rng.integers(0, 64, (37, 48), dtype=np.uint8), 0
    if name == "one row":
        return _hll_like(rng, 1, 1 << 10), 0
    if name == "p=14 dense genome rows":
        return _dense_like(rng, 203, 1 << 14), 0
    if name == "p=14 one value a row":
        return np.repeat(np.arange(64, dtype=np.uint8)[:, None], 1 << 14,
                         axis=1), 0
    return _hll_like(rng, 9, 1 << 14), 1  # "from byte 1"


ROW_HIST_CASES = ("p=14 skewed, zero rows", "R=100", "R=48 uniform",
                  "one row", "from byte 1", "p=14 dense genome rows",
                  "p=14 one value a row")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROW_HIST_CASES)
def test_row_hist_kernel_matches_plain(cuda, name):
    """row_hist on a CUDA tensor launches the kernel once and gives the
    plain version's histograms and values, numpy's row bincounts and
    bank_values' values."""
    regs, offset = _row_hist_bank(name)
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.uint8), regs.reshape(-1)])).to(cuda)
    d = flat[offset:].view(regs.shape)
    before = screen.row_hist.launches
    hist, vals = screen.row_hist(d)
    torch.cuda.synchronize()
    assert screen.row_hist.launches == before + 1
    want, want_vals = screen._row_hist_plain(d, 2048)
    assert hist.dtype == torch.int32 and torch.equal(hist, want)
    np.testing.assert_array_equal(
        hist.cpu().numpy(),
        np.stack([np.bincount(row, minlength=64) for row in regs]))
    assert vals == want_vals == screen.bank_values(regs)


@pytest.mark.cuda
def test_row_hist_kernel_refuses_64_and_takes_empty(cuda):
    """A register of 64 (or more) raises ValueError, as the plain version
    and native.row_hist do; no rows launch nothing."""
    regs = _hll_like(np.random.default_rng(64), 24, 1 << 12)
    for v in (64, 255):
        bad = regs.copy()
        bad[17, 999] = v
        d = torch.from_numpy(bad).to(cuda)
        with pytest.raises(ValueError, match=">= 64"):
            screen.row_hist(d)
        with pytest.raises(ValueError, match=">= 64"):
            screen._row_hist_plain(d, 2048)
    before = screen.row_hist.launches
    hist, vals = screen.row_hist(torch.zeros((0, 64), dtype=torch.uint8,
                                             device=cuda))
    assert hist.shape == (0, 64) and vals == ()
    assert screen.row_hist.launches == before


@pytest.mark.cuda
def test_row_hist_kernel_rows_at_the_limit(cuda):
    """One row of 2^31 - 1 registers (the largest R an int holds; every
    lane's counters take 2^26 counts) gives the plain version's histogram
    and numpy's bincount; a row of 2^31 registers raises before any
    launch."""
    r = (1 << 31) - 1
    gen = torch.Generator(device=cuda).manual_seed(31)
    d = torch.randint(0, 64, (1, r), generator=gen, dtype=torch.uint8,
                      device=cuda)
    hist, vals = screen.row_hist(d)
    torch.cuda.synchronize()
    want, want_vals = screen._row_hist_plain(d, 2048)
    assert torch.equal(hist, want) and vals == want_vals
    host = d.cpu().numpy().reshape(-1)
    counts = sum(np.bincount(host[c:c + (1 << 27)], minlength=64)
                 for c in range(0, r, 1 << 27))
    np.testing.assert_array_equal(hist.cpu().numpy()[0], counts)
    del d, host, want
    torch.cuda.empty_cache()
    before = screen.row_hist.launches
    with pytest.raises(ValueError, match="2\\^31"):
        screen.row_hist(torch.zeros((1, 1 << 31), dtype=torch.uint8,
                                    device=cuda))
    assert screen.row_hist.launches == before


@pytest.mark.cuda
def test_plan_cards_from_the_card_are_host_cards(cuda):
    """A bank without cards: the plan's row_hist pass and the MLE kernel
    (cards_from_hists, no row on the host) give host_cards' bits, and its
    order is the stable argsort of them; a bank with cards keeps its
    own."""
    rng = np.random.default_rng(5)
    regs = synth.synthetic_regs(3000, rng.integers(64, 9000, 3000), 12, rng)
    bank = SketchBank(names=[f"g{i}" for i in range(3000)], regs=regs, p=12)
    assert not bank.has_cards()
    before = screen.row_hist.launches
    mle_before = estimators.ertl_mle.launches
    plan = screened.ScreenPlan(bank, SelectionParams(tau=0.9,
                                                     criterion="cb"),
                               512, device=cuda)
    assert screen.row_hist.launches == before + 1
    assert estimators.ertl_mle.launches == mle_before + 1
    print(f"plan cards of 3000 rows: cards_host_rows {plan.cards_host_rows}")
    assert plan.cards_host_rows == 0
    want = host_cards(regs, 12)
    assert bank.has_cards()
    np.testing.assert_array_equal(bank.cards.view(np.int64),
                                  want.view(np.int64))
    np.testing.assert_array_equal(plan.order,
                                  np.argsort(want, kind="stable"))
    assert plan.values == screen.truncate_values(
        screen.bank_values(regs), float(np.trunc(want).max()), 12)
    e = np.full(3000, 7.0)
    kept = SketchBank(names=bank.names, regs=regs, p=12, cards=e)
    screened.ScreenPlan(kept, SelectionParams(tau=0.9, criterion="cb"), 512,
                        device=cuda)
    assert kept.cards is e


@pytest.mark.cuda
@pytest.mark.parametrize("use_smh", [True, False])
def test_k1_through_a_row_map_matches_plain(cuda, use_smh):
    """K1 on a bank in another row order with one zero row, read through a
    map (the plan's layout): bit-equal to its plain version through the
    map and to the kernel on the gathered sorted bank, through both entry
    points; the strip entry with slices of the map on each side."""
    regs, e, fp = _inputs(900 + use_smh, 0, 12, 384, 8)
    regs[-5:] = 0
    rng = np.random.default_rng(901)
    perm = rng.permutation(384).astype(np.int32)
    perm[-5:] = 384
    bank = np.zeros((385, 256), np.uint8)
    bank[perm[:-5]] = regs[:-5]
    d_bank, d_map, d_sorted, e_t, fp_t = [
        torch.from_numpy(x).to(cuda) for x in (bank, perm, regs, e, fp)]
    vals = screen.bank_values(regs)
    tiles = screen.launch_tiles([0, 0, 2, 5, 3], [0, 4, 2, 5, 5], True, cuda)
    kw = dict(n_real=379, tau_scr=0.4, tau_cb=0.35, p=8, values=vals, ti=64,
              n_bands=4, use_cb=True, use_smh=use_smh)
    got = screen.screen_hits_fused(d_bank, tiles, e_t, fp_t, row_map=d_map,
                                   **kw)
    strip = screen.screen_hits_fused_strips(
        d_bank, d_bank, tiles, e_t, e_t, fp_t, fp_t, 0, 0, row_map=d_map,
        col_map=d_map, **kw)
    plain = screen._screen_hits_fused_plain(
        d_bank, tiles.row_tiles, tiles.col_tiles, e_t, fp_t, row_map=d_map,
        **kw)
    on_sorted = screen.screen_hits_fused(d_sorted, tiles, e_t, fp_t, **kw)
    torch.cuda.synchronize()
    for out in (strip, plain, on_sorted):
        assert torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])
    assert int(got[1].sum()) > 0
    st = screen.launch_tiles([0, 1, 2], [2, 0, 1], False, cuda)
    rows, cols = slice(64, 256), slice(128, 320)
    args = (d_bank, d_bank, st, e_t[rows], e_t[cols], fp_t[rows], fp_t[cols],
            64, 128)
    skw = dict(kw, row_map=d_map[rows], col_map=d_map[cols])
    got = screen.screen_hits_fused_strips(*args, **skw)
    want = screen.screen_hits_fused_strips(
        d_sorted[rows], d_sorted[cols], st, *args[3:], **kw)
    plain = screen._screen_hits_fused_strips_plain(
        d_bank, d_bank, st.row_tiles, st.col_tiles, *args[3:], **skw)
    torch.cuda.synchronize()
    for out in (want, plain):
        assert torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])


# The ERTL-MLE kernel (csrc/ertl_mle.cu): every row of these inputs
# bit-equal to its plain version in f64 and f32, flags included.


def _mle_rows(p, seed):
    """int64 histograms at p: 1001 pair unions, 300 rows on the log1p
    branch (_mle_histograms), and an empty row, a saturated one, one bin,
    zeros with saturated registers, two far bins: 1306 rows, not a
    multiple of the kernel's 128-row CTA."""
    q, m = 64 - p, 1 << p
    edge = np.zeros((5, 64), np.int64)
    edge[0, 0] = m
    edge[1, q + 1] = m
    edge[2, 7] = m
    edge[3, 0], edge[3, q + 1] = m // 2, m - m // 2
    edge[4, 1], edge[4, q] = m - 3, 3
    return np.concatenate([_mle_histograms(p, 1001, seed, False),
                           _mle_histograms(p, 300, seed + 1, True), edge])


def _mle_vs_plain(counts, p, dtype):
    """The kernel on `counts` (a CUDA tensor) against its plain version on
    the same tensor: bit-equal estimates and log1p flags, one launch."""
    before = estimators.ertl_mle.launches
    got, flags = estimators.ertl_mle(counts, p, dtype=dtype, branch=True)
    want = estimators._ertl_mle_plain(counts, p, dtype=dtype)
    want_flags = estimators.log1p_branch(counts, p, dtype)
    torch.cuda.synchronize()
    assert estimators.ertl_mle.launches == before + (counts.numel() > 0)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(flags, want_flags)
    return got, flags


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 14])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("in_dtype", [torch.int32, torch.int64,
                                      torch.float32])
def test_ertl_mle_kernel_matches_plain(cuda, p, dtype, in_dtype):
    """Every row of the crafted histograms, in each histogram type the
    kernel reads: the plain version's bits and flags."""
    h = torch.from_numpy(_mle_rows(p, 60 + p)).to(cuda, in_dtype)
    _, flags = _mle_vs_plain(h, p, dtype)
    assert int(flags.sum()) >= 301  # the log1p set and the saturated row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ertl_mle_kernel_on_engine_histograms(cuda, dtype):
    """The histograms the callers hold, where they lie: row_hist's int32
    (N, 64) of a p=14 bank; a dense tile's f32 (Bi, Bj, q + 2) unions at
    p=14 and at p_aux=8; and the first q + 2 bins of a wider last
    dimension, read through its row stride."""
    rng = np.random.default_rng(71)
    regs = synth.synthetic_regs(3000, rng.integers(64, 40_000, 3000), 14,
                                rng)
    d = torch.from_numpy(regs).to(cuda)
    hist, _ = screen.row_hist(d)
    _mle_vs_plain(hist, 14, dtype)
    _mle_vs_plain(pairwise.union_histograms(d[:256], d[256:768], 14), 14,
                  dtype)
    aux, _ = synth.synthetic_hll_banks(512, rng.integers(64, 40_000, 512),
                                       (8, 6), rng)
    a = torch.from_numpy(aux).to(cuda)
    unions = pairwise.union_histograms(a[:256], a, 8)
    assert unions.shape == (256, 512, 58)
    _mle_vs_plain(unions, 8, dtype)
    wide = torch.zeros((256, 512, 64), dtype=torch.float32, device=cuda)
    wide[..., :58] = unions
    got, _ = _mle_vs_plain(wide[..., :58], 8, dtype)
    assert torch.equal(got, estimators.ertl_mle(unions, 8, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 14])
def test_ertl_mle_kernel_zero_ulp_off_log1p(cuda, p):
    """The f64 kernel against hostref.ertl_mle_batch: 0 ulp on every row
    off the log1p branch (the flag's complement); on it within the 4 ulp
    of the libraries' log1p."""
    h = _mle_rows(p, 80 + p)
    got, flags = estimators.ertl_mle(torch.from_numpy(h).to(cuda), p,
                                     branch=True)
    got, flags = got.cpu().numpy(), flags.cpu().numpy()
    ulps = _ulps(got, hostref.ertl_mle_batch(h, p))
    assert (~flags).sum() >= 1001
    assert ulps[~flags].max() == 0
    assert ulps[flags].max() <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [torch.int32, torch.float32])
def test_cards_from_hists_on_cuda_are_host_cards(cuda, in_dtype):
    """cards_from_hists on the card: bit-equal to host_cards' MLE of the
    same histograms on every row, the log1p rows recomputed on the host
    and counted."""
    h = _mle_rows(14, 91)
    cards, host_rows = tbank.cards_from_hists(
        torch.from_numpy(h).to(cuda, in_dtype), 14)
    want = tbank.mle_rows(h, 14)
    print(f"cards_from_hists of {len(h)} rows: {host_rows} host rows")
    assert host_rows == int(estimators.log1p_branch(torch.from_numpy(h),
                                                    14).sum())
    assert host_rows >= 301
    np.testing.assert_array_equal(cards.view(np.int64), want.view(np.int64))


# csrc/ertl_mle.cu's CTA: kWarps warps of kRows = 32 rows each
MLE_CTA_ROWS = 64


def _mle_law_rows(p, n, seed):
    """int64 (n + 5, 64) histograms at any p without a register bank: n
    rows of real-sized genomes (synth.genome_hists), then an empty row, a
    saturated one, one bin, a row on the log1p branch (registers only at
    q - 1, q and q + 1) and zeros with saturated registers."""
    q, m = 64 - p, 1 << p
    h = synth.genome_hists(n, p, np.random.default_rng(seed)).astype(
        np.int64)
    edge = np.zeros((5, 64), np.int64)
    edge[0, 0] = m
    edge[1, q + 1] = m
    edge[2, min(7, q)] = m
    edge[3, q], edge[3, q - 1] = max(1, m // 5), 1 if m > 4 else 0
    edge[3, q + 1] = m - edge[3, q] - edge[3, q - 1]
    edge[4, 0], edge[4, q + 1] = m // 2, m - m // 2
    return np.concatenate([h, edge])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, MLE_CTA_ROWS - 1, MLE_CTA_ROWS,
                               MLE_CTA_ROWS + 1, 1306])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ertl_mle_kernel_row_counts(cuda, n, dtype):
    """Batches of 1, a CTA's rows less one, a CTA's rows, one more and
    1306 rows (crafted rows, shuffled): the plain version's bits and
    flags."""
    h = _mle_rows(14, 90)
    idx = np.random.default_rng(n).permutation(len(h))[:n]
    _mle_vs_plain(torch.from_numpy(h[idx]).to(cuda, torch.int32), 14, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 8, 14, 24])
@pytest.mark.parametrize("in_dtype", [torch.int32, torch.int64,
                                      torch.float32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ertl_mle_kernel_strided_slice(cuda, p, in_dtype, dtype):
    """The first q + 2 bins of rows 71 elements apart, from one element
    into a buffer (a base 4 or 8 bytes off a 16-byte boundary; the fast
    route for int32 and float32, the plain route for int64), at p = 2,
    8, 14 and 24: the plain version's bits and flags."""
    nb, stride = 66 - p, 71
    h = _mle_law_rows(p, 3 * MLE_CTA_ROWS + 7, 31 + p)
    n = len(h)
    buf = torch.full((1 + n * stride + 5,), 7, dtype=in_dtype)
    rows = buf[1:1 + n * stride].view(n, stride)
    rows[:, :nb] = torch.from_numpy(h[:, :nb]).to(in_dtype)
    d = buf.to(cuda)[1:1 + n * stride].view(n, stride)[:, :nb]
    assert d.stride() == (stride, 1)
    assert d.data_ptr() % 16 != 0
    _mle_vs_plain(d, p, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ertl_mle_kernel_on_genome_rows(cuda, dtype):
    """Rows of real-sized genomes (no zero register, longer secant loops
    than the bench bank's), as row_hist lays them out: the plain
    version's bits, no row on the log1p branch; in f64 0 ulp from
    hostref.ertl_mle_batch, and cards_from_hists equal to host_cards' MLE
    with no host row."""
    h = synth.genome_hists(3000, 14, np.random.default_rng(0x6E0))
    d = torch.from_numpy(h).to(cuda)
    got, flags = _mle_vs_plain(d, 14, dtype)
    assert not bool(flags.any())
    if dtype == torch.float64:
        want = hostref.ertl_mle_batch(h, 14)
        assert _ulps(got.cpu().numpy(), want).max() == 0
        cards, host_rows = tbank.cards_from_hists(d, 14)
        assert host_rows == 0
        np.testing.assert_array_equal(cards.view(np.int64),
                                      want.view(np.int64))


@pytest.mark.cuda
def test_ertl_mle_kernel_refuses_and_takes_empty(cuda):
    """A histogram type or layout the kernel does not take raises before
    any launch; an empty batch launches nothing."""
    h = torch.zeros((4, 6, 64), dtype=torch.int32, device=cuda)
    before = estimators.ertl_mle.launches
    for bad in (h.to(torch.int16), h.permute(1, 0, 2), h[..., :51]):
        with pytest.raises(ValueError, match="ertl_mle"):
            estimators.ertl_mle(bad, 14)
    est, flags = estimators.ertl_mle(h[:0], 14, branch=True)
    assert est.shape == (0, 6) and flags.shape == (0, 6)
    assert estimators.ertl_mle.launches == before


def _band_fp_inputs(cuda, m, n_rows, n_bands, n=band_fp_cases.N):
    aux = band_fp_cases.aux_bank(m, seed=m + n_rows, n=n)
    bank, rows, aux_p = band_fp_cases.plan_layout(aux, seed=n_bands)
    return (torch.from_numpy(bank.view(np.int64)).to(cuda),
            torch.from_numpy(rows).to(cuda), aux_p)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_rows,n_bands", band_fp_cases.SPLITS)
@pytest.mark.parametrize("n", [band_fp_cases.N, 5000])
def test_band_fp_kernel_matches_plain(cuda, m, n_rows, n_bands, n):
    """The band-fingerprint kernel through a shuffled map with padded
    positions on the zero row: bit-equal to its plain version and to
    band_fingerprints_np of the host-sorted, zero-padded aux, at every
    split of the CPU tests (top-bit and all-ones words)."""
    d_aux, d_rows, aux_p = _band_fp_inputs(cuda, m, n_rows, n_bands, n)
    before = screened.band_fingerprints.launches
    got = screened.band_fingerprints(d_aux, d_rows, n_rows, n_bands)
    torch.cuda.synchronize()
    assert screened.band_fingerprints.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (len(d_rows), n_bands)
    assert torch.equal(got, screened._band_fingerprints_plain(
        d_aux, d_rows, n_rows, n_bands))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        screened.band_fingerprints_np(aux_p, n_rows, n_bands))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_rows,n_bands", [(32, 4, 8), (64, 1, 64)])
def test_band_fp_kernel_on_an_unaligned_bank(cuda, m, n_rows, n_bands):
    """A bank that starts 8 bytes past a 16-byte boundary takes the
    one-word loads: still bit-equal to the plain version."""
    d_aux, d_rows, aux_p = _band_fp_inputs(cuda, m, n_rows, n_bands, 999)
    flat = torch.empty(d_aux.numel() + 1, dtype=torch.int64, device=cuda)
    shifted = flat[1:].view(d_aux.shape)
    shifted.copy_(d_aux)
    assert shifted.data_ptr() % 16 == 8
    got = screened.band_fingerprints(shifted, d_rows, n_rows, n_bands)
    assert torch.equal(got, screened._band_fingerprints_plain(
        d_aux, d_rows, n_rows, n_bands))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        screened.band_fingerprints_np(aux_p, n_rows, n_bands))


@pytest.mark.cuda
def test_band_fp_kernel_refuses_and_takes_empty(cuda):
    """A map naming a row outside the bank, a map on the host and a split
    that is not m raise before any launch; an empty map launches
    nothing."""
    d_aux, d_rows, _ = _band_fp_inputs(cuda, 32, 4, 8)
    before = screened.band_fingerprints.launches
    for args in ((d_aux, d_rows.cpu(), 4, 8), (d_aux, d_rows, 8, 8),
                 (d_aux, d_rows + 1, 4, 8), (d_aux, d_rows - 40, 4, 8)):
        with pytest.raises(ValueError, match="band_fingerprints"):
            screened.band_fingerprints(*args)
    empty = screened.band_fingerprints(d_aux, d_rows[:0], 4, 8)
    assert empty.shape == (0, 8) and empty.device.type == "cuda"
    assert screened.band_fingerprints.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("crit,tau", [("smh_a", 0.9), ("smh_only", 0.8)])
def test_plan_fp_on_the_card(cuda, crit, tau):
    """The plan on the card: the smh aux bank goes up unsorted with one
    zero row, one kernel launch reads it through d_rows, and d_fp equals
    band_fingerprints_np of the host-sorted, zero-padded aux; no sorted
    host aux is gathered, and select_pairs' lines equal the CPU's."""
    rng = np.random.default_rng(17)
    n, m = 3000, 32
    regs = synth.synthetic_regs(n, rng.integers(64, 9000, n), 12, rng)
    aux = synth.synthetic_aux(n, m, rng)
    aux[::7, 3] |= np.uint64(1 << 63)
    synth.plant_near_duplicates(regs, aux, rng, 40)
    bank = SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=12,
                      aux_kind="smh", aux=aux, aux_param=m)
    params = SelectionParams(tau=tau, criterion=crit, engine="screened")
    before = screened.band_fingerprints.launches
    plan = screened.ScreenPlan(bank, params, 512, device=cuda)
    assert screened.band_fingerprints.launches == before + 1
    n_rows, n_bands = criteria.smh_band_params(m, tau)
    assert plan.n_bands == n_bands and plan.fp_secs > 0.0
    aux_p = np.zeros((plan.n_pad, m), np.uint64)
    aux_p[:n] = aux[plan.order]
    np.testing.assert_array_equal(
        plan.d_fp.cpu().numpy(),
        screened.band_fingerprints_np(aux_p, n_rows, n_bands))
    assert plan.aux_s is None
    got = select_pairs(bank, params, device=cuda)
    assert got == select_pairs(bank, params, device="cpu") and len(got) > 0


# (k, rows, registers a row, i0, alphabet without 0): odd row counts, i0 >
# 0; rows of 1, 17 and 2049 bytes a plane (R/8 not a multiple of 4) take
# the byte path, every other the word path, at k = 1 to 7; 2100 rows of
# 513 words a plane: a grid stride (256 threads times the CTAs) is never a
# multiple of an odd W, and the 1,077,300 groups outrun it
UNPACK_CASES = [(1, 7, 136, 3, False), (2, 9, 8, 1, True),
                (3, 33, 16384, 5, True), (4, 101, 512, 0, False),
                (5, 5, 136, 11, True), (6, 65, 16392, 2, False),
                (7, 3, 1024, 9, True), (1, 9, 1024, 4, False),
                (2, 17, 4096, 2, True), (5, 40, 16384, 3, False),
                (6, 21, 2048, 7, True), (4, 2100, 16416, 1, False)]


def _unpack_case(k, s, r, no_zero, device):
    """Host rows of a seeded alphabet of 2^k - 1 values (2 at k = 1), and
    their planes and table on the card."""
    rng = np.random.default_rng(k * 1000 + r)
    vals = sorted(rng.choice(np.arange(int(no_zero), 256),
                             (1 << k) - (k > 1), replace=False).tolist())
    lut, table, kk = regpack.plan_pack(vals)
    assert kk == k
    rows = rng.choice(np.array(vals, np.uint8), size=(s, r))
    packed = torch.from_numpy(regpack.pack_rows(rows, lut, k)).to(device)
    return rows, packed, torch.from_numpy(table).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,r,i0,no_zero", UNPACK_CASES)
def test_regpack_unpack_matches_plain(cuda, k, s, r, i0, no_zero):
    """The unpack kernel decodes packed planes into rows i0 .. i0 + S of a
    bank on the card, bit-equal to _unpack_rows_plain, leaving the other
    rows alone, on the path its shape gives (the bank is 16-byte
    aligned at every row of a multiple of 16 bytes)."""
    rows, packed, d_table = _unpack_case(k, s, r, no_zero, cuda)
    fill = torch.full((i0 + s + 2, r), 7, dtype=torch.uint8, device=cuda)
    want = regpack._unpack_rows_plain(fill.clone(), packed, d_table, i0, k)
    got = fill.clone()
    assert regpack.unpack_path(got, packed, i0) == (
        "word" if r % 32 == 0 else "byte")
    before = regpack.unpack_rows.launches
    assert regpack.unpack_rows(got, packed, d_table, i0, k) is got
    torch.cuda.synchronize()
    assert regpack.unpack_rows.launches == before + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got[i0:i0 + s].cpu().numpy(), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 6, 7])
def test_regpack_unpack_8_byte_aligned_view_takes_byte_path(cuda, k):
    """A word-path shape decoded into a bank view whose base is aligned to
    8 bytes but not 16 takes the byte path, bit-equal to the plain
    version, with the bytes around the view untouched."""
    s, r, i0 = 33, 16384, 2
    rows, packed, d_table = _unpack_case(k, s, r, False, cuda)
    flat = torch.full(((i0 + s + 1) * r + 16,), 7, dtype=torch.uint8,
                      device=cuda)
    out = flat[8:8 + (i0 + s + 1) * r].view(i0 + s + 1, r)
    assert out.data_ptr() % 16 == 8 and out.is_contiguous()
    assert regpack.unpack_path(out, packed, i0) == "byte"
    aligned = torch.full((i0 + s + 1, r), 7, dtype=torch.uint8, device=cuda)
    assert regpack.unpack_path(aligned, packed, i0) == "word"
    want = regpack._unpack_rows_plain(aligned.clone(), packed, d_table, i0,
                                      k)
    regpack.unpack_rows(out, packed, d_table, i0, k)
    regpack.unpack_rows(aligned, packed, d_table, i0, k)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(aligned, want)
    assert (flat[:8] == 7).all() and (flat[8 + out.numel():] == 7).all()
    np.testing.assert_array_equal(out[i0:i0 + s].cpu().numpy(), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [True, False])
def test_packed_upload_equals_raw_on_cuda(cuda, ordered):
    """A packed upload through pinned arenas, two device packed slabs and
    the unpack kernel gives the raw upload's bank, over many slabs with a
    part-filled last one; the plan's packed bank equals its raw one."""
    rng = np.random.default_rng(5)
    n, r = 1001, 4096
    regs = synth.synthetic_regs(n, rng.integers(64, 90000, n), 12, rng)
    order = rng.permutation(n) if ordered else None
    plan = regpack.plan_pack(regpack.host_values(regs))
    stats = {}
    before = regpack.unpack_rows.launches
    got = screened.upload_sorted_rows(regs, order, 7, 1024, cuda,
                                      slab_bytes=100 * r, stats=stats,
                                      pack=plan)
    raw = screened.upload_sorted_rows(regs, order, 7, 1024, cuda,
                                      slab_bytes=100 * r)
    assert torch.equal(got, raw)
    assert stats["slabs"] == 10 and stats["pack_bits"] == plan[2]
    assert regpack.unpack_rows.launches == before + 10
    bank = SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=12)
    params = SelectionParams(tau=0.9, criterion="cb")
    packed_plan = screened.ScreenPlan(bank, params, 512, cuda,
                                      upload_pack=True)
    raw_plan = screened.ScreenPlan(bank, params, 512, cuda)
    assert packed_plan.upload_stats["pack_bits"] == plan[2]
    assert torch.equal(packed_plan.d_bank, raw_plan.d_bank)
    assert packed_plan.values == raw_plan.values


@functools.lru_cache(maxsize=1)
def _reference_bank():
    """chip_smoke.py phase 4's sketch bank (synth.planted_file_banks(2048):
    64 planted near-duplicates) with its host cards."""
    regs, _, aux = synth.planted_file_banks(2048)
    return regs, aux, host_cards(regs, 14)


@pytest.mark.cuda
@pytest.mark.parametrize("aux_mode,tau,n_pairs", [
    ("drawn", 0.9, None),        # the reference's run: the gate first
    ("equal", 0.9, None),        # every pair takes hll_union_card
    ("equal", -1.0, 1_000_003),  # every J kept; not a multiple of a CTA
    ("drawn", 0.9, 777_777),
])
def test_reference_kernel_matches_plain(cuda, aux_mode, tau, n_pairs):
    """kernel_CBsmh gives its plain version's sorted lines with bit-equal
    f32 sims at N=2048, with the aux as drawn and with every aux row equal
    (then every pair reaches the union), over the whole pair list and over
    prefixes that end inside a CTA. Bit-equal because each union's largest
    register is at most 39: the kernel's sum of 2^-r in register order and
    the plain version's sum by value are then both exact, and both take
    CUDA's f64 division and log."""
    regs, aux, cards = _reference_bank()
    if aux_mode == "equal":
        aux = np.broadcast_to(aux[:1], aux.shape)
    assert regs.max() <= 39
    before = reference_kernel.launch.launches
    got = reference_kernel.reference_pairs(regs, aux, cards, tau, cuda,
                                           n_pairs)
    assert reference_kernel.launch.launches == before + 1
    want = reference_kernel.plain_lines(regs, aux, cards, tau, cuda, n_pairs)
    assert len(got[0]) >= (64 if n_pairs is None else 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if tau < 0:
        assert len(got[0]) == n_pairs


@pytest.mark.cuda
def test_reference_kernel_raises_past_its_capacity(cuda):
    """A count above the output's capacity raises at the fetch: the kernel
    counts the results it cannot store, and none is dropped in silence."""
    regs, aux, cards = _reference_bank()
    aux = np.broadcast_to(aux[:1], aux.shape)
    prep = reference_kernel.prepare(regs[:64], aux[:64], cards[:64], -1.0,
                                    cuda, capacity=10)
    reference_kernel.launch(prep)
    with pytest.raises(RuntimeError, match="2016 results counted"):
        reference_kernel.fetch(prep)
