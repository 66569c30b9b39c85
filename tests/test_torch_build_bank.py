"""The port's build path end to end against the JAX package, on the CPU:
build_bank_from_files on synthetic FASTA/FASTQ files (bank arrays and
written sketch bytes), the build_sketch CLI (files and --bank), selection
-c smh_only on the sketches it wrote, and time_smh's CSV rows."""

import filecmp
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from cuda_selection_criteria_tpu.cli import build_sketch as jbuild_cli
from cuda_selection_criteria_tpu.cli import selection as jsel_cli
from cuda_selection_criteria_tpu.cli import time_smh as jtime_cli
from cuda_selection_criteria_tpu.models import bank as jbank
from cuda_selection_criteria_tpu.parallel.selection import (
    SelectionParams as JParams)
from cuda_selection_criteria_tpu.parallel.selection import (
    select_pairs as jselect_pairs)
from cuda_selection_criteria_tpu_torch.cli import build_sketch as build_cli
from cuda_selection_criteria_tpu_torch.cli import selection as sel_cli
from cuda_selection_criteria_tpu_torch.cli import time_smh as time_cli
from cuda_selection_criteria_tpu_torch.models import SketchBank
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams, format_results, select_pairs)
from cuda_selection_criteria_tpu_torch.utils import fasta, formats
from cuda_selection_criteria_tpu_torch.utils.hostref import select_pairs_host

BASES = np.frombuffer(b"ACGT", np.uint8)


def _records_text(recs, width, eol):
    """FASTA text of [(name, bytes)] in lines of `width`."""
    out = []
    for name, seq in recs:
        out.append(b">" + name + eol)
        out.extend(seq[i:i + width] + eol for i in range(0, len(seq), width))
    return b"".join(out)


def write_corpus(d, seed=11):
    """Eight genomes under directory d: FASTA gz and plain, multi-record,
    60- and 80-column lines, lowercase runs, N and IUPAC runs, CRLF line
    ends; a near-copy of genome 0 (5 SNPs); two FASTQ files of 60-base
    reads. Returns the file paths."""
    rng = np.random.default_rng(seed)
    files = []
    base = BASES[rng.integers(0, 4, 6000)]
    for g in range(6):
        seq = base.copy() if g < 2 else BASES[rng.integers(
            0, 4, int(rng.integers(2000, 7000)))]
        if g == 1:
            idx = rng.integers(0, seq.size, 5)
            seq[idx] = BASES[(np.searchsorted(BASES, seq[idx]) + 1) % 4]
        seq[rng.integers(0, seq.size, 6)] = ord("N")
        seq[100:103] = np.frombuffer(b"RYK", np.uint8)
        lo = int(rng.integers(0, seq.size - 200))
        seq[lo:lo + 150] += 32  # lowercase run
        recs = [(b"chr%d desc" % g, seq.tobytes())]
        if g % 2 == 0:
            recs.append((b"plasmid", BASES[rng.integers(0, 4, 300)].tobytes()))
        text = _records_text(recs, 60 if g % 3 else 80,
                             b"\r\n" if g == 2 else b"\n")
        path = os.path.join(d, f"g{g}.fna" + (".gz" if g != 3 else ""))
        with (gzip.open if path.endswith(".gz") else open)(path, "wb") as fh:
            fh.write(text)
        files.append(path)
    for q in range(2):
        reads = [BASES[rng.integers(0, 4, 60)].tobytes() for _ in range(3)]
        text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"@" * len(r))
                        for i, r in enumerate(reads))
        path = os.path.join(d, f"reads{q}.fq" + (".gz" if q else ""))
        with (gzip.open if q else open)(path, "wb") as fh:
            fh.write(text)
        files.append(path)
    return files


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")))


def _copy(files, d):
    os.makedirs(d)
    out = [os.path.join(d, os.path.basename(f)) for f in files]
    for f, g in zip(files, out):
        shutil.copyfile(f, g)
    return out


def _list(files, path):
    with open(path, "w") as fh:
        fh.write("\n".join(files) + "\n")
    return str(path)


def _sketch_files(files, crit, aux_bytes):
    kind, param = tbank.aux_spec(crit, aux_bytes)
    sfx = [".hll"] + ([f".hll_{param}"] if kind == "hll" else
                      [f".smh{param}"])
    return [f + s for f in files for s in sfx]


def _same_bytes(a_files, b_files):
    for a, b in zip(a_files, b_files):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.mark.parametrize("aux_bytes", [32, 256, 512])
@pytest.mark.parametrize("crit", ["smh_a", "hll_a", "hll_an"])
def test_build_bank_matches_jax(corpus, tmp_path, crit, aux_bytes):
    jfiles = _copy(corpus, tmp_path / "jax")
    tfiles = _copy(corpus, tmp_path / "torch")
    jb = jbank.build_bank_from_files(jfiles, crit, aux_bytes,
                                     backend="device")
    stats = {}
    tb = tbank.build_bank_from_files(tfiles, crit, aux_bytes,
                                     backend="device", device="cpu",
                                     stats=stats)
    np.testing.assert_array_equal(tb.regs, jb.regs)
    assert tb.aux.dtype == jb.aux.dtype
    np.testing.assert_array_equal(tb.aux, jb.aux)
    assert (tb.aux_kind, tb.aux_param) == (jb.aux_kind, jb.aux_param)
    np.testing.assert_array_equal(tb.cards, jb.cards)
    assert stats["genomes"] == len(corpus) and stats["packs"] >= 1
    assert stats["codes"] == sum(fasta.fasta_codes(f).size for f in corpus)
    if crit == "smh_a" and aux_bytes >= 256:  # the reads fill < m buckets
        assert stats["smh_fallbacks"] >= 1
    jb.write_sketch_files()
    tb.write_sketch_files()
    _same_bytes(_sketch_files(tfiles, crit, aux_bytes),
                _sketch_files(jfiles, crit, aux_bytes))


def test_build_bank_chunked_and_packed_paths_agree(corpus, monkeypatch):
    """Genomes above the pack budget take the per-genome chunked path: the
    bank is the same either way."""
    packed = tbank.build_bank_from_files(corpus, "smh_a", 256,
                                         backend="device", device="cpu")
    monkeypatch.setattr(tbank, "PACK_CODES", 1024)
    stats = {}
    chunked = tbank.build_bank_from_files(corpus, "smh_a", 256,
                                          backend="device", device="cpu",
                                          stats=stats)
    assert stats["chunked_genomes"] == 6
    np.testing.assert_array_equal(chunked.regs, packed.regs)
    np.testing.assert_array_equal(chunked.aux, packed.aux)


def test_build_sketch_cli_matches_jax(corpus, tmp_path, capsys):
    """Same sketch bytes as the JAX CLI with --backend device; --bank
    round-trips through load_bank and SketchBank.save/load."""
    jfiles = _copy(corpus, tmp_path / "jax")
    tfiles = _copy(corpus, tmp_path / "torch")
    assert jbuild_cli.main(["-l", _list(jfiles, tmp_path / "j.txt"), "-a",
                            "256", "-c", "smh_a", "--backend", "device"]) == 0
    stats = {}
    npz = str(tmp_path / "bank.npz")
    assert build_cli.main(["-l", _list(tfiles, tmp_path / "t.txt"), "-a",
                           "256", "-c", "smh_a", "-t", "2", "--device", "cpu",
                           "--bank", npz], stats=stats) == 0
    assert stats["genomes"] == len(corpus)
    _same_bytes(_sketch_files(tfiles, "smh_a", 256),
                _sketch_files(jfiles, "smh_a", 256))
    bank = SketchBank.from_sketch_files(tfiles, criterion="smh_a")
    saved = formats.load_bank(npz)
    assert list(saved["names"]) == tfiles
    np.testing.assert_array_equal(saved["regs"], bank.regs)
    np.testing.assert_array_equal(saved["aux"], bank.aux)
    np.testing.assert_array_equal(saved["cards"], bank.cards)
    assert str(saved["aux_kind"]) == "smh"
    for shards in (1, 3):
        bank.save(str(tmp_path / f"b{shards}"), shards=shards)
        back = SketchBank.load(str(tmp_path / f"b{shards}"))
        assert back.names == bank.names and back.aux_param == 32
        np.testing.assert_array_equal(back.regs, bank.regs)
        np.testing.assert_array_equal(back.aux, bank.aux)
    capsys.readouterr()
    for main in (build_cli.main, jbuild_cli.main):
        assert main(["-l", "x", "-c", "nope"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == ("Option -c invalid. The accepted criteria "
                                "are hll_a, hll_an and smh_a.")


def test_build_refuses_missing_card(corpus, tmp_path):
    """No silent fallback: the default device is CUDA, which raises on a
    machine without a card, for backend "auto" (the device pipeline, never
    the host builder) and "device", in the function and the CLI; an
    unknown backend raises. (backend="native": tests/test_torch_native.py.)"""
    with pytest.raises(ValueError, match="unknown backend"):
        tbank.build_bank_from_files(corpus, "smh_a", backend="host")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for backend in ("auto", "device"):
        with pytest.raises((AssertionError, RuntimeError)):
            tbank.build_bank_from_files(corpus, "smh_a", backend=backend)
    lst = _list(corpus, tmp_path / "list.txt")
    with pytest.raises((AssertionError, RuntimeError)):
        build_cli.main(["-l", lst, "-c", "hll_a"])


def _stdout(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def built_list(corpus, tmp_path_factory):
    """The corpus with .hll and .smh4 sketches written by the port's CLI,
    and its file list."""
    d = tmp_path_factory.mktemp("built")
    files = _copy(corpus, d / "fa")
    lst = _list(files, d / "list.txt")
    assert build_cli.main(["-l", lst, "-a", "32", "-c", "smh_a", "--backend",
                           "device", "--device", "cpu"]) == 0
    return lst, files


def test_selection_smh_only_on_built_sketches(built_list, capsys):
    """selection -c smh_only (the smh_a band gate without CB) prints the
    JAX CLI's lines and the host reference's; select_pairs agrees."""
    lst, files = built_list
    for tau in ("0.9", "0.2"):
        argv = ["-l", lst, "-a", "32", "-h", tau, "-c", "smh_only"]
        got = _stdout(sel_cli.main, argv + ["--device", "cpu"], capsys)
        assert got == _stdout(jsel_cli.main, argv, capsys)
        bank = SketchBank.from_sketch_files(files, criterion="smh_a",
                                            aux_bytes=32)
        host = select_pairs_host(bank, float(tau), "smh_only",
                                 apply_cb=False)
        assert got.splitlines() == format_results(host)
        jb = jbank.SketchBank.from_sketch_files(files, criterion="smh_a",
                                                aux_bytes=32)
        assert select_pairs(bank, SelectionParams(
            tau=float(tau), criterion="smh_only", engine="screened"),
            device="cpu") == \
            jselect_pairs(jb, JParams(tau=float(tau), criterion="smh_only"))
    assert {"g0.fna.gz", "g1.fna.gz"} in [
        {os.path.basename(a), os.path.basename(b)} for a, b, _ in host]


def test_time_smh_rows_match_jax(built_list, capsys):
    """The five row kinds with the JAX rows' fields; every field but the
    seconds equal."""
    lst, _ = built_list
    argv = ["-l", lst, "-m", "16", "-h", "0.5", "-R", "2", "-t", "2"]
    got = _stdout(time_cli.main, argv + ["--device", "cpu"], capsys)
    want = _stdout(jtime_cli.main, argv, capsys)
    rows = [r.split(";") for r in got.splitlines()]
    wrows = [r.split(";") for r in want.splitlines()]
    assert len(rows) == len(wrows) == 9
    for r, w in zip(rows, wrows):
        assert len(r) == len(w) == 5
        assert r[:3] + r[4:] == w[:3] + w[4:]
        assert float(r[3]) >= 0.0
    assert [r[1] for r in rows] == [
        "build_smh", "smh_a", "CB+smh_a", "smh_a", "CB+smh_a",
        "smh_a_kernel", "smh_a_kernel", "CB+smh_a_kernel", "CB+smh_a_kernel"]
    assert rows[0][4] == "m:16"
    assert _stdout(time_cli.main, ["-x", "-l", lst], capsys) == \
        _stdout(jtime_cli.main, ["-x", "-l", lst], capsys)
