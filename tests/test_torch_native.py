"""The port's native host library (native/fastx.cpp, built by g++ at first
use) against the JAX package's native library and against the port's plain
Python and numpy paths, on the same inputs made from a numpy seed: FASTA
decode, the single-pass host builder (backend="native"), the threaded
sketch-file loaders, the fused union histograms and the row histograms of
the bank's cardinalities; and the plain paths when the library cannot be
built."""

import gzip
import os

import numpy as np
import pytest

from test_torch_build_bank import (_copy, _list, _same_bytes, _sketch_files,
                                   write_corpus)
from torch_banks import jax_bank, jax_bank_hll, one_torch_thread, port_bank

from cuda_selection_criteria_tpu.cli import build_sketch as jbuild_cli
from cuda_selection_criteria_tpu.models import bank as jbank
from cuda_selection_criteria_tpu.native import fastx as jfastx
from cuda_selection_criteria_tpu.utils import hostref as jhostref
from cuda_selection_criteria_tpu_torch.cli import build_sketch as build_cli
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.native import fastx
from cuda_selection_criteria_tpu_torch.ops import _build
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    format_results)
from cuda_selection_criteria_tpu_torch.utils import fasta, formats, hostref

PKG = os.path.dirname(os.path.abspath(tbank.__file__ + "/.."))
BASES = np.frombuffer(b"ACGT", np.uint8)

_ = one_torch_thread  # a fixture, used by name


def _seq(rng, n, letters=b"ACGT"):
    return np.frombuffer(letters, np.uint8)[rng.integers(0, len(letters),
                                                         n)].tobytes()


def _lines(seq, width, eol=b"\n"):
    return b"".join(seq[i:i + width] + eol for i in range(0, len(seq), width))


def _edge_file(d, case):
    """One input of the decode edge cases, made from a seed."""
    rng = np.random.default_rng(len(case))
    gz = True
    if case == "lower_n_iupac":
        seq = bytearray(_seq(rng, 3000))
        seq[100:400] = seq[100:400].lower()
        seq[900:960] = b"N" * 60
        seq[1500:1512] = b"RYKMSWBDHVNn"
        seq[2000:2030] = b"n" * 30
        text = b">chr1 lowercase, N runs and IUPAC\n" + _lines(bytes(seq), 60)
    elif case == "crlf":
        text = b"".join(b">r%d\r\n" % i + _lines(_seq(rng, 500), 70, b"\r\n")
                        for i in range(3))
    elif case == "multi_record":
        text = b"".join(b">rec%d desc\n" % i + _lines(
            _seq(rng, int(rng.integers(1, 900)), b"ACGTacgtN"), 80) + b"\n"
            for i in range(6))
    elif case == "fastq_at_plus":
        reads = [_seq(rng, int(rng.integers(20, 90))) for _ in range(5)]
        text = b"".join(b"@q%d\n%s\n+\n%s\n" % (
            i, r, (b"@+" * len(r))[:len(r)]) for i, r in enumerate(reads))
    elif case == "plain":
        gz = False
        text = b">plain\n" + _lines(_seq(rng, 2500, b"ACGTN"), 60)
    elif case == "two_gzip_members":
        path = os.path.join(d, "two.fa.gz")
        with open(path, "wb") as fh:
            for i in range(2):
                fh.write(gzip.compress(b">m%d\n" % i
                                       + _lines(_seq(rng, 1200), 60)))
        return path
    else:  # empty
        gz = False
        text = b""
    path = os.path.join(d, case + (".fa.gz" if gz else ".fa"))
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(text)
    return path


EDGE_CASES = ["lower_n_iupac", "crlf", "multi_record", "fastq_at_plus",
              "plain", "two_gzip_members", "empty"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fasta_codes_native_matches_python_and_jax(tmp_path, case):
    """The port's native reader is bit-equal to the JAX package's on every
    input; utils/fasta.fasta_codes (native here) to both packages' Python
    readers. The two differ only on a file without records: the native
    readers emit their leading reset, the Python readers nothing."""
    path = _edge_file(str(tmp_path), case)
    nat = fastx.fasta_codes(path)
    np.testing.assert_array_equal(nat, jfastx.fasta_codes(path))
    py = fasta.fasta_codes_py(path)
    assert fasta.decoder() == "native"
    got = fasta.fasta_codes(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(got, jfastx.fasta_codes(path)
                                  if case != "empty" else py)
    if case == "empty":
        assert py.size == 0 and nat.tolist() == [4]
    else:
        np.testing.assert_array_equal(nat, py)
        assert py.size > 1 and py[0] == 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")))


@pytest.mark.parametrize("crit,aux_bytes", [
    ("smh_a", 32), ("smh_a", 256), ("smh_a", 4096), ("hll_a", 256),
    ("hll_a", 512), ("hll_an", 256), ("hll_an", 512)])
def test_native_backend_matches_device_and_jax(corpus, one_torch_thread,
                                               crit, aux_bytes):
    """backend="native" bank bit-equal to the port's device pipeline on the
    CPU and to the JAX package's native builder; build_sketches per file
    equal to the JAX one's, k-mer counts included."""
    st_nat, st_dev = {}, {}
    nat = tbank.build_bank_from_files(corpus, crit, aux_bytes, io_threads=3,
                                      backend="native", stats=st_nat)
    dev = tbank.build_bank_from_files(corpus, crit, aux_bytes,
                                      backend="device", device="cpu",
                                      stats=st_dev)
    jnat = jbank.build_bank_from_files(corpus, crit, aux_bytes,
                                       backend="native")
    for bank in (dev, jnat):
        np.testing.assert_array_equal(nat.regs, bank.regs)
        assert nat.aux.dtype == bank.aux.dtype
        np.testing.assert_array_equal(nat.aux, bank.aux)
        np.testing.assert_array_equal(nat.cards, bank.cards)
        assert (nat.aux_kind, nat.aux_param) == (bank.aux_kind,
                                                 bank.aux_param)
    assert st_nat["backend"] == "native" and st_nat["io_threads"] == 3
    assert st_dev["backend"] == "device" and st_dev["decoder"] == "native"
    if crit == "smh_a" and aux_bytes >= 256:  # the reads fill < m buckets
        assert st_dev["smh_fallbacks"] >= 1
    kind, param = tbank.aux_spec(crit, aux_bytes)
    kw = dict(p_aux=param, m=0) if kind == "hll" else dict(p_aux=0, m=param)
    kmers = 0
    for f in corpus:
        got = fastx.build_sketches(f, k=31, p=14, **kw)
        want = jfastx.build_sketches(f, k=31, p=14, **kw)
        for g, w in zip(got[:3], want[:3]):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
        kmers += got[3]
    assert st_nat["kmers"] == kmers > 0


@pytest.mark.parametrize("crit,aux_bytes", [("smh_a", 256), ("hll_an", 512)])
def test_native_files_match_jax_cli_device(corpus, tmp_path, crit,
                                           aux_bytes):
    """Sketch files of build_bank_from_files(backend="native", io_threads=3)
    and of the build_sketch CLI with --backend native -t 3 byte-identical
    to the JAX CLI's --backend device files. The native backend never
    touches a device: it runs with device="cuda" on a machine without a
    card."""
    jfiles = _copy(corpus, tmp_path / "jax")
    assert jbuild_cli.main(["-l", _list(jfiles, tmp_path / "j.txt"), "-a",
                            str(aux_bytes), "-c", crit, "--backend",
                            "device"]) == 0
    want = _sketch_files(jfiles, crit, aux_bytes)
    bfiles = _copy(corpus, tmp_path / "bank")
    tbank.build_bank_from_files(bfiles, crit, aux_bytes, io_threads=3,
                                backend="native",
                                device="cuda").write_sketch_files()
    _same_bytes(_sketch_files(bfiles, crit, aux_bytes), want)
    cfiles = _copy(corpus, tmp_path / "cli")
    stats = {}
    assert build_cli.main(["-l", _list(cfiles, tmp_path / "c.txt"), "-a",
                           str(aux_bytes), "-c", crit, "--backend", "native",
                           "-t", "3"], stats=stats) == 0
    assert (stats["backend"], stats["io_threads"]) == ("native", 3)
    _same_bytes(_sketch_files(cfiles, crit, aux_bytes), want)


def test_backends_never_cross(corpus, monkeypatch, one_torch_thread):
    """backend="native" runs no device step and "auto" runs no host
    builder: each path is replaced by one that raises."""
    def boom(*a, **k):
        raise AssertionError("the other backend ran")

    monkeypatch.setattr(tbank, "_build_bank_native", boom)
    stats = {}
    tbank.build_bank_from_files(corpus, "hll_a", 256, io_threads=3,
                                device="cpu", stats=stats)
    assert (stats["backend"], stats["decoder"], stats["io_threads"]) == (
        "device", "native", 3)
    monkeypatch.undo()
    monkeypatch.setattr(tbank, "_launch_pack", boom)
    monkeypatch.setattr(tbank, "sketch_codes_device", boom)
    monkeypatch.setattr(tbank, "resolve", boom)
    tbank.build_bank_from_files(corpus, "hll_a", 256, backend="native")


def test_decode_lookahead_is_bounded(monkeypatch):
    """The device pipeline's decode threads run at most 2 * threads files
    ahead of the consumer, and hand the files back in order."""
    started = []
    monkeypatch.setattr(tbank, "_decode",
                        lambda f: (started.append(f) or f, 0.0))
    files = [f"f{i}" for i in range(25)]
    got = []
    for codes, _ in tbank._decoded(files, 3):
        assert len(started) <= len(got) + 1 + 2 * 3
        got.append(codes)
    assert got == files


def _sketch_dir(d, n=12, seed=5):
    """n genomes' .hll (p=14), .hll_8 and .smh32 files with random
    contents; returns the genome paths."""
    rng = np.random.default_rng(seed)
    names = [os.path.join(d, f"g{i:02d}.fna") for i in range(n)]
    for name in names:
        formats.write_hll(name + ".hll", 14,
                          rng.integers(0, 20, 1 << 14, dtype=np.uint8))
        formats.write_hll(name + ".hll_8", 8,
                          rng.integers(0, 30, 1 << 8, dtype=np.uint8))
        formats.write_smh(name + ".smh32",
                          rng.integers(0, 1 << 63, 32, dtype=np.uint64))
    return names


@pytest.fixture(scope="module")
def sketches(tmp_path_factory):
    return _sketch_dir(str(tmp_path_factory.mktemp("sketches")))


@pytest.mark.parametrize("sfx,p", [(".hll", 14), (".hll_8", 8)])
def test_read_hll_batch_matches_numpy(sketches, sfx, p):
    paths = [f + sfx for f in sketches]
    got = fastx.read_hll_batch(paths, p, threads=3)
    want = np.stack([formats.read_hll(f)[1] for f in paths])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jfastx.read_hll_batch(paths, p, 3))
    np.testing.assert_array_equal(tbank.load_hll_bank(paths, p, 3), want)


def test_read_smh_batch_matches_numpy(sketches):
    paths = [f + ".smh32" for f in sketches]
    got = fastx.read_smh_batch(paths, 32, threads=3)
    want = np.stack([formats.read_smh(f) for f in paths])
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jfastx.read_smh_batch(paths, 32, 3))
    np.testing.assert_array_equal(tbank.load_smh_bank(paths, 32, 3), want)


@pytest.mark.parametrize("crit", [None, "smh_a", "hll_a", "hll_an"])
def test_from_sketch_files_threads_match_numpy(sketches, crit):
    """from_sketch_files(io_threads=3) equals the numpy readers' arrays and
    the JAX package's bank."""
    bank = SketchBank.from_sketch_files(sketches, criterion=crit,
                                        io_threads=3)
    np.testing.assert_array_equal(bank.regs, np.stack(
        [formats.read_hll(f + ".hll")[1] for f in sketches]))
    if crit == "smh_a":
        want = np.stack([formats.read_smh(f + ".smh32") for f in sketches])
    elif crit is not None:
        want = np.stack([formats.read_hll(f + ".hll_8")[1]
                         for f in sketches])
    if crit is not None:
        np.testing.assert_array_equal(bank.aux, want)
    jb = jbank.SketchBank.from_sketch_files(sketches, criterion=crit,
                                            io_threads=3)
    np.testing.assert_array_equal(bank.regs, jb.regs)
    np.testing.assert_array_equal(bank.cards, jb.cards)
    assert (bank.aux_kind, bank.aux_param) == (jb.aux_kind, jb.aux_param)


@pytest.mark.parametrize("case", ["missing_hll", "wrong_p", "missing_smh",
                                  "wrong_m"])
def test_batch_readers_raise_ioerror(sketches, case):
    """A missing file, a .hll of another p and a .smh of another bucket
    count raise IOError from the batch readers. The loaders then take the
    numpy readers, as the JAX package's do: a missing file raises there
    too, a file of another size is read as it is."""
    hll = [f + ".hll" for f in sketches]
    smh = [f + ".smh32" for f in sketches]
    if case == "missing_hll":
        batch = lambda: fastx.read_hll_batch(hll + ["/nonexistent"], 14)
        load = lambda mod: mod.load_hll_bank(hll + ["/nonexistent"], 14)
    elif case == "wrong_p":
        batch = lambda: fastx.read_hll_batch(hll, 12)
        load = lambda mod: mod.load_hll_bank(hll, 12)
    elif case == "missing_smh":
        batch = lambda: fastx.read_smh_batch(smh + ["/nonexistent"], 32)
        load = lambda mod: tbank.load_smh_bank(smh + ["/nonexistent"], 32)
    else:
        batch = lambda: fastx.read_smh_batch(smh, 16)
        load = lambda mod: tbank.load_smh_bank(smh, 16)
    with pytest.raises(IOError):
        batch()
    if case.startswith("missing"):
        with pytest.raises(IOError):
            load(tbank)
    else:
        got = load(tbank)
        if case == "wrong_p":
            np.testing.assert_array_equal(got, load(jbank))
        np.testing.assert_array_equal(got, np.stack(
            [formats.read_hll(f)[1] for f in hll] if case == "wrong_p" else
            [formats.read_smh(f) for f in smh]))


@pytest.mark.parametrize("p,threads", [(8, 1), (8, 3), (14, None)])
def test_pair_union_hist_matches_numpy_and_jax(p, threads):
    rng = np.random.default_rng(p)
    regs = rng.integers(0, 64 - p + 2, size=(40, 1 << p), dtype=np.uint8)
    ii = rng.integers(0, 40, 300)
    kk = rng.integers(0, 40, 300)
    ii[:5] = kk[:5]
    want = hostref.pair_union_histograms_np(regs, ii, kk)
    got = fastx.pair_union_hist(regs, ii, kk, threads)
    assert got.dtype == np.int64 and got.shape == (300, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jfastx.pair_union_hist(regs, ii, kk, threads))
    assert hostref.hist_backend() == "native"
    np.testing.assert_array_equal(
        hostref.pair_union_histograms(regs, ii, kk), want)
    np.testing.assert_array_equal(
        got, jhostref.pair_union_histograms(regs, ii, kk))


@pytest.mark.parametrize("case", ["register_64", "row_past_end",
                                  "negative_row"])
def test_pair_union_hist_rejects_bad_inputs(case):
    regs = np.ones((6, 256), np.uint8)
    ii, kk = np.array([0, 1, 2]), np.array([3, 4, 5])
    if case == "register_64":
        regs[4, 17] = 64
    elif case == "row_past_end":
        kk[2] = 6
    else:
        ii[0] = -1
    with pytest.raises(ValueError):
        fastx.pair_union_hist(regs, ii, kk)
    with pytest.raises(ValueError):
        hostref.pair_union_histograms(regs, ii, kk)


def _row_hist_bank(p, n, seed):
    """n rows of 2^p registers in [0, q+1], the first all zero and the
    second all q+1 (where there are that many rows), a few q+1 values
    elsewhere."""
    q = 64 - p
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, q + 2, size=(n, 1 << p), dtype=np.uint8)
    regs[rng.random(regs.shape) < 0.5] = 0
    regs[:1] = 0
    regs[1:2] = q + 1
    return regs


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("p", [4, 8, 14])
def test_row_hist_matches_numpy(p, threads):
    """fastx.row_hist equals the numpy row histograms (host_cards' plain
    version) on banks of 0, 1 and 2049 rows, with all-zero rows and rows
    holding q+1."""
    for n in (0, 1, 2049):
        regs = _row_hist_bank(p, n, 10 * p + threads)
        got = fastx.row_hist(regs, threads)
        assert got.dtype == np.int64 and got.shape == (n, 64)
        np.testing.assert_array_equal(got, tbank._row_hists_numpy(regs))
        if n:
            assert got[0, 0] == 1 << p and got[:, 64 - p + 2:].sum() == 0
        if n > 1:
            assert got[1, 64 - p + 1] == 1 << p


@pytest.mark.parametrize("case", ["register_64", "register_255", "int32",
                                  "one_d", "three_d"])
def test_row_hist_rejects_bad_inputs(case):
    regs = np.ones((6, 256), np.uint8)
    if case.startswith("register"):
        regs[4, 17] = int(case.split("_")[1])
    elif case == "int32":
        regs = regs.astype(np.int32)
    elif case == "one_d":
        regs = regs[0]
    else:
        regs = regs.reshape(3, 2, 256)
    with pytest.raises(ValueError):
        fastx.row_hist(regs)


def test_host_cards_takes_the_native_histograms(monkeypatch):
    """Where the library builds, host_cards never runs the numpy loop, and
    its cards equal the MLE of the numpy histograms bit for bit."""
    regs = _row_hist_bank(10, 300, 7)
    want = hostref.ertl_mle_batch(tbank._row_hists_numpy(regs), 10)

    def numpy_loop(_):
        raise AssertionError("host_cards took the numpy histograms")

    monkeypatch.setattr(tbank, "_row_hists_numpy", numpy_loop)
    got = tbank.host_cards(regs, 10)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("crit", ["smh_a", "cb", "baseline", "hll_a",
                                  "hll_an"])
def test_oracle_on_native_histograms_unchanged(crit):
    """PairOracle.confirm_pairs through the native histograms (its default)
    gives the numpy histograms' pairs and Jaccards over every pair, and
    select_pairs_host the JAX package's lines."""
    if crit.startswith("hll"):
        jb = jax_bank_hll(40, 10, 6, 3)
    else:
        jb = jax_bank(40, 10, 16, 3)
    bank = port_bank(jb)
    order = bank.sorted_by_cardinality()
    aux = None if bank.aux is None else bank.aux[order]
    regs = bank.regs[order]
    kw = dict(aux=aux, aux_param=bank.aux_param, criterion=crit, tau=0.1,
              apply_cb=crit != "baseline")
    e = np.trunc(bank.cards[order])
    nat = hostref.PairOracle(bank.p, regs, e, **kw)
    ref = hostref.PairOracle(
        bank.p, regs, e, hist_fn=lambda ii, kk:
        hostref.pair_union_histograms_np(regs, ii, kk), **kw)
    pairs = list(zip(*np.triu_indices(bank.n, 1)))
    got = nat.confirm_pairs(pairs, batch=256)
    assert got == ref.confirm_pairs(pairs, batch=256) and got
    lines = format_results(hostref.select_pairs_host(
        bank, 0.1, crit, apply_cb=crit != "baseline"))
    assert lines == format_results(jhostref.select_pairs_host(
        jb, 0.1, crit, apply_cb=crit != "baseline"))
    assert len(lines) == len(got)


def test_library_is_the_ports_own():
    """Built from native/fastx.cpp of the port into the port's build
    directory; the JAX package's library is not what this process loaded
    for the port."""
    assert fastx.available()
    info = fastx.info()
    assert info["error"] is None and info["zlib"]
    path = os.path.realpath(info["path"])
    assert path.startswith(os.path.join(os.path.realpath(PKG), "build") +
                           os.sep)
    assert "cuda_selection_criteria_tpu" + os.sep + "native" not in path
    assert os.path.realpath(fastx.SOURCE) == os.path.join(
        os.path.realpath(PKG), "native", "fastx.cpp")
    with open(f"/proc/{os.getpid()}/maps") as fh:
        maps = fh.read()
    assert path in maps


def test_build_host_into_fresh_dir(tmp_path, monkeypatch):
    """A fresh build directory: g++ builds the library under a name hashed
    from its source, flags and CPU, renamed into place (no temporary file
    left), and a second call finds it."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    path, secs, log = _build.build_host(fastx.SOURCE, "fastx")
    assert os.path.dirname(path) == str(tmp_path) and secs > 0
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert "-lz -lpthread" in log
    assert _build.build_host(fastx.SOURCE, "fastx") == (path, 0.0, "")


def test_build_host_failure_raises(tmp_path, monkeypatch):
    """g++ failing (here: a library that does not exist) raises with its
    log and leaves no library or temporary file behind."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "GXX_LIBS", ["-lz_missing_for_the_test"])
    with pytest.raises(RuntimeError, match="lz_missing_for_the_test"):
        _build.build_host(fastx.SOURCE, "fastx")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """A fresh process state with the compiler path pointing to a missing
    binary and an empty build directory: the library cannot be built."""
    monkeypatch.setattr(_build, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(fastx, "_state", {})
    assert not fastx.available()
    assert "no-such-g++ not found" in fastx.info()["error"]


def test_no_compiler_native_backend_raises(corpus, tmp_path, no_compiler):
    with pytest.raises(ImportError, match="no-such-g"):
        tbank.build_bank_from_files(corpus, "smh_a", backend="native")
    with pytest.raises(ImportError):
        build_cli.main(["-l", _list(corpus, tmp_path / "l.txt"), "-c",
                        "hll_a", "--backend", "native"])
    for call in (lambda: fastx.fasta_codes(corpus[0]),
                 lambda: fastx.read_hll_batch([], 14)):
        with pytest.raises(ImportError):
            call()


def test_no_compiler_decoder_is_python(tmp_path, monkeypatch,
                                       one_torch_thread):
    """fasta_codes reports and runs the Python reader, with the native
    reader's bytes; the device pipeline then decodes on one thread."""
    paths = [_edge_file(str(tmp_path), c) for c in EDGE_CASES]
    want = [fasta.fasta_codes(p) for p in paths]
    assert fasta.decoder() == "native"
    monkeypatch.setattr(_build, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(fastx, "_state", {})
    assert fasta.decoder() == "python"
    for path, w in zip(paths, want):
        np.testing.assert_array_equal(fasta.fasta_codes(path), w)
    stats = {}
    tbank.build_bank_from_files(paths[:4], "smh_a", 32, io_threads=4,
                                device="cpu", stats=stats)
    assert (stats["decoder"], stats["io_threads"]) == ("python", 1)


def test_no_compiler_oracle_and_loaders_use_numpy(sketches, no_compiler):
    """The oracle's histograms, the loaders and the cards take the numpy
    paths and give the native paths' bytes and cards."""
    rng = np.random.default_rng(2)
    regs = rng.integers(0, 50, size=(20, 1 << 10), dtype=np.uint8)
    ii, kk = rng.integers(0, 20, 64), rng.integers(0, 20, 64)
    assert hostref.hist_backend() == "numpy"
    np.testing.assert_array_equal(
        hostref.pair_union_histograms(regs, ii, kk),
        jfastx.pair_union_hist(regs, ii, kk))
    bank = SketchBank.from_sketch_files(sketches, criterion="smh_a",
                                        io_threads=3)
    np.testing.assert_array_equal(bank.regs, jfastx.read_hll_batch(
        [f + ".hll" for f in sketches], 14))
    np.testing.assert_array_equal(bank.aux, jfastx.read_smh_batch(
        [f + ".smh32" for f in sketches], 32))
    with pytest.raises(IOError):
        tbank.load_hll_bank([f + ".hll" for f in sketches] + ["/none"], 14)
    rows = np.arange(bank.n)
    want = hostref.ertl_mle_batch(jfastx.pair_union_hist(
        bank.regs, rows, rows), 14)
    np.testing.assert_array_equal(bank.cards.view(np.int64),
                                  want.view(np.int64))
    np.testing.assert_array_equal(
        tbank.host_cards(regs, 10).view(np.int64),
        hostref.ertl_mle_batch(jfastx.pair_union_hist(
            regs, np.arange(20), np.arange(20)), 10).view(np.int64))
