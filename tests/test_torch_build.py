"""The port's sketch build ops (hashes, k-mers, HLL and SuperMinHash builds,
the FASTA reader, the sketch models and the chunked per-genome path) held
bit-equal to the JAX package and to the scalar models of refmodels.py, on
the CPU, on inputs made from a numpy seed."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refmodels as rm
from cuda_selection_criteria_tpu.models import HllSketch as JHll
from cuda_selection_criteria_tpu.models import SuperMinHashSketch as JSmh
from cuda_selection_criteria_tpu.ops import hashes as jhashes
from cuda_selection_criteria_tpu.ops import hll_build as jhll
from cuda_selection_criteria_tpu.ops import kmers as jkmers
from cuda_selection_criteria_tpu.ops import smh_build as jsmh
from cuda_selection_criteria_tpu.utils import fasta as jfasta
from cuda_selection_criteria_tpu_torch.models import (HllSketch,
                                                      SuperMinHashSketch)
from cuda_selection_criteria_tpu_torch.models import bank as tbank
from cuda_selection_criteria_tpu_torch.ops import hashes, hll_build, kmers
from cuda_selection_criteria_tpu_torch.ops import smh_build
from cuda_selection_criteria_tpu_torch.utils import fasta
from cuda_selection_criteria_tpu_torch.utils.device import u64_numpy

CPU = "cpu"
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _u64(n, seed, edge=True):
    """n uniform uint64 values, with 0, 1, 2^32 +- 1, 2^63 and 2^64 - 1
    in front when `edge`."""
    x = np.random.default_rng(seed).integers(0, 1 << 64, size=n,
                                             dtype=np.uint64)
    if edge:
        x[:7] = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63,
                 (1 << 64) - 1]
    return x


def _eq_u64(got, want):
    np.testing.assert_array_equal(u64_numpy(got), np.asarray(want))


# -- ops/hashes ------------------------------------------------------------

def test_wang_hash64_matches_jax_and_scalar():
    x = _u64(2000, 1)
    got = hashes.wang_hash64(x, CPU)
    _eq_u64(got, jhashes.wang_hash64(x))
    assert [int(v) for v in u64_numpy(got[:50])] == \
        [rm.wang(int(v)) for v in x[:50]]


@pytest.mark.parametrize("k", [21, 31, 32])
def test_canonical_kmer_matches_jax_and_scalar(k):
    """k=32 fills all 64 bits: the unsigned-min hazard of a signed
    torch.minimum."""
    x = _u64(2000, k) >> np.uint64(64 - 2 * k)
    _eq_u64(hashes.reverse_complement(x, k, CPU),
            jhashes.reverse_complement(x, k))
    got = hashes.canonical_kmer(x, k, CPU)
    _eq_u64(got, jhashes.canonical_kmer(x, k))
    assert [int(v) for v in u64_numpy(got[:50])] == \
        [rm.canonical(int(v), k) for v in x[:50]]
    if k == 32:  # both orders of the sign bit occur
        assert (u64_numpy(got) >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("limbs", ["near_2_32", "near_2_64", "random"])
def test_umul128_fold_matches_jax_and_scalar(limbs):
    rng = np.random.default_rng(3)
    if limbs == "near_2_32":
        a = np.uint64(1 << 32) + rng.integers(-5, 6, 200).astype(np.uint64)
    elif limbs == "near_2_64":
        a = np.uint64((1 << 64) - 1) - rng.integers(0, 1 << 33, 200,
                                                    dtype=np.uint64)
    else:
        a = _u64(200, 4)
    b = _u64(200, 5)
    got = hashes.umul128_fold(a, b, CPU)
    _eq_u64(got, jhashes.umul128_fold(a, b))
    assert [int(v) for v in u64_numpy(got)] == \
        [rm.wymum(int(x), int(y)) for x, y in zip(a, b)]


def test_wyrand_draws_matches_jax():
    """Seed 0 maps to 1337; seeds of 2^63 and above wrap like uint64."""
    seeds = _u64(300, 6)
    seeds[7] = 1337  # equal draws to seed 0
    got = u64_numpy(hashes.wyrand_draws(seeds, 9, CPU))
    np.testing.assert_array_equal(got, np.asarray(
        jhashes.wyrand_draws(seeds, 9)))
    np.testing.assert_array_equal(got[0], got[7])
    assert (seeds >= np.uint64(1 << 63)).sum() > 100


def test_clz64_matches_jax_and_scalar():
    x = _u64(2000, 8)
    x[7:70] = np.uint64(1) << np.arange(63, dtype=np.uint64)
    got = hashes.clz64(x, CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhashes.clz64(x)))
    assert got[0] == 64 and got[5] == 0 and got[6] == 0
    assert [int(v) for v in got[:80]] == [rm.clz64(int(v)) for v in x[:80]]


def test_unsigned_min_orders_the_sign_bit():
    a = torch.tensor([-1, 5, -(1 << 63), 7], dtype=torch.int64)
    b = torch.tensor([3, -2, 0, 7], dtype=torch.int64)
    assert hashes.umin(a, b).tolist() == [3, 5, 0, 7]


# -- ops/kmers and utils/fasta ---------------------------------------------

def _stream(kind, rng):
    if kind == "short":  # shorter than k
        return rng.integers(0, 4, 20).astype(np.uint8)
    codes = rng.integers(0, 4, 6000).astype(np.uint8)
    if kind == "sentinels":  # resets, and valid runs shorter than k
        codes[rng.integers(0, 6000, 150)] = 4
        codes[1000:1100:9] = 4
    return codes


@pytest.mark.parametrize("kind", ["clean", "sentinels", "short"])
@pytest.mark.parametrize("k", [21, 31, 32])
def test_canonical_kmers_match_jax(kind, k):
    codes = _stream(kind, np.random.default_rng(len(kind) + k))
    got, valid = kmers.canonical_kmers(codes, k, CPU)
    want, wvalid = jkmers.canonical_kmers(jnp.asarray(codes), k)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    _eq_u64(got, want)
    assert valid.dtype == torch.bool and not valid[:k - 1].any()


def _write(path, text, gz):
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(text)


@pytest.mark.parametrize("name", ["multi.fa.gz", "crlf.fa", "reads.fq.gz",
                                  "reads.fq", "empty.fa"])
def test_fasta_reader_matches_jax_and_scanner(tmp_path, name):
    """FASTA and FASTQ, gz and plain, multi-record, multi-line, lowercase,
    N and IUPAC codes, CRLF line ends; the valid canonical k-mers equal the
    reference scanner's (refmodels.kmers_from_fasta) for gz FASTA."""
    rng = np.random.default_rng(len(name))
    recs = ["".join(rng.choice(list("ACGTacgtNRY"), int(n)))
            for n in rng.integers(1, 300, 5)]
    if name.startswith("multi"):
        text = "".join(f">r{i} desc\n" + "\n".join(
            s[j:j + 60] for j in range(0, len(s), 60)) + "\n"
            for i, s in enumerate(recs))
    elif name.startswith("crlf"):
        text = "".join(f">r{i}\r\n{s[:40]}\r\n{s[40:]}\r\n"
                       for i, s in enumerate(recs))
    elif name.startswith("reads"):  # quality lines start with '@' and '+'
        text = "".join(f"@q{i}\n{s}\n+\n{'@+' * (len(s) // 2)}"
                       f"{'I' * (len(s) % 2)}\n" for i, s in enumerate(recs))
    else:
        text = ""
    path = str(tmp_path / name)
    _write(path, text.encode(), name.endswith(".gz"))
    got = fasta.fasta_codes(path)
    np.testing.assert_array_equal(got, jfasta.fasta_codes_py(path))
    if name == "multi.fa.gz":
        kms, valid = kmers.canonical_kmers(got, 31, CPU)
        np.testing.assert_array_equal(
            u64_numpy(kms[valid]),
            np.array(rm.kmers_from_fasta(path), np.uint64))


# -- ops/hll_build ---------------------------------------------------------

def _items(n, seed, n_genomes):
    rng = np.random.default_rng(seed)
    kms = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    valid = rng.random(n) < 0.9
    gids = rng.integers(0, n_genomes, n).astype(np.int32)
    return kms, valid, gids


@pytest.mark.parametrize("p", [14, 5, 6, 7, 8])
def test_hll_build_batch_matches_jax_and_scalar(p):
    kms, valid, gids = _items(6000, p, 3)
    got = hll_build.hll_build_batch(kms, valid, gids, p, 3, CPU)
    assert got.dtype == torch.uint8 and got.shape == (3, 1 << p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jhll.hll_build_batch(jnp.asarray(kms), jnp.asarray(valid),
                             jnp.asarray(gids), p, 3)))
    for g in range(3):
        np.testing.assert_array_equal(got[g].numpy(), rm.build_hll(
            [int(x) for x in kms[valid & (gids == g)]], p))


def test_hll_update_and_merge_equal_oneshot():
    kms, _, _ = _items(4000, 11, 1)
    ones = np.ones(2000, bool)
    a = hll_build.hll_build_batch(kms[:2000], ones, np.zeros(2000, np.int32),
                                  12, 1, CPU)[0]
    merged = hll_build.hll_update(a, kms[2000:], ones, 12, CPU)
    want = rm.build_hll([int(x) for x in kms], 12)
    np.testing.assert_array_equal(merged.numpy(), want)
    b = hll_build.hll_build_batch(kms[2000:], ones, np.zeros(2000, np.int32),
                                  12, 1, CPU)[0]
    np.testing.assert_array_equal(hll_build.hll_merge_max(a, b).numpy(), want)


# -- ops/smh_build ---------------------------------------------------------

def _smh_case(case, m):
    """(kmers, valid, gids, n_genomes) for a complete batch, a batch with
    an incomplete tiny genome, and one with a zero-seed item."""
    rng = np.random.default_rng(m + len(case))
    if case == "complete":
        kms, valid, gids = _items(40 * m, m, 2)
        return kms, valid, gids, 2
    if case == "tiny":  # genome 1 has fewer items than buckets
        kms, valid, gids = _items(30 * m, m + 1, 1)
        gids = np.concatenate([gids, np.ones(3, np.int32)])
        kms = np.concatenate([kms, rng.integers(0, 1 << 62, 3,
                                                dtype=np.uint64)])
        return kms, np.concatenate([valid, np.ones(3, bool)]), gids, 3
    kms = np.array([0, 5, 9], np.uint64)  # seed 0 -> 1337
    return kms, np.ones(3, bool), np.zeros(3, np.int32), 1


@pytest.mark.parametrize("case", ["complete", "tiny", "zero_seed"])
@pytest.mark.parametrize("m", [4, 32, 512])
def test_smh_builds_match_jax_and_sequential(case, m):
    kms, valid, gids, ng = _smh_case(case, m)
    j = [jnp.asarray(x) for x in (kms, valid, gids)]
    h0, complete = smh_build.smh_build_batch_j0(kms, valid, gids, m, ng, CPU)
    jh0, jcomplete = jsmh.smh_build_batch_j0(*j, m, ng)
    _eq_u64(h0, jh0)
    assert bool(complete) == bool(jcomplete) == (case == "complete")
    full = smh_build.smh_build_batch_full(kms, valid, gids, m, ng, CPU)
    _eq_u64(full, jsmh.smh_build_batch_full(*j, m, ng))
    got = smh_build.smh_build_batch(kms, valid, gids, m, ng, CPU)
    _eq_u64(got, jsmh.smh_build_batch(*j, m, ng))
    _eq_u64(got, u64_numpy(full))
    # genome 0 against the sequential reference with its a_/b_ early exit
    sel = valid & (gids == 0)
    if m <= 32 or case == "zero_seed":
        np.testing.assert_array_equal(u64_numpy(got[0]), rm.build_smh_sequential(
            [int(x) for x in kms[sel]], m))
    if case == "tiny":  # empty and unhit buckets stay U64_MAX
        assert (u64_numpy(got[2]) == U64_MAX).all()


def test_smh_candidates_match_jax():
    kms, valid, _ = _items(500, 21, 1)
    buckets, cands = smh_build.smh_candidates(kms, valid, 16, CPU)
    jb, jc = jsmh.smh_candidates(jnp.asarray(kms), jnp.asarray(valid), 16)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(jb))
    _eq_u64(cands, jc)
    assert (u64_numpy(cands[~torch.from_numpy(valid)]) == U64_MAX).all()


def test_smh_merge_and_update_are_unsigned():
    """Merging with an empty sketch (all U64_MAX, -1 as int64) keeps the
    other sketch: a signed min would keep the empty value."""
    kms, _, _ = _items(600, 12, 1)
    ones = np.ones(300, bool)
    zeros = np.zeros(300, np.int32)
    a = smh_build.smh_build_batch(kms[:300], ones, zeros, 16, 1, CPU)[0]
    b = smh_build.smh_build_batch(kms[300:], ones, zeros, 16, 1, CPU)[0]
    want = rm.build_smh_sequential([int(x) for x in kms], 16)
    np.testing.assert_array_equal(u64_numpy(smh_build.smh_merge_min(a, b)),
                                  want)
    np.testing.assert_array_equal(u64_numpy(smh_build.smh_update(
        a, kms[300:], ones, 16, CPU)), want)
    empty = torch.full((16,), -1, dtype=torch.int64)
    assert torch.equal(smh_build.smh_merge_min(empty, a), a)


# -- models ------------------------------------------------------------------

def test_sketch_models_match_jax():
    codes = np.concatenate([[4], np.random.default_rng(13).integers(
        0, 4, 5000)]).astype(np.uint8)
    codes2 = codes.copy()
    codes2[::400] = (codes2[::400] + 1) % 4
    hs = [HllSketch.from_codes(c, 12, device=CPU) for c in (codes, codes2)]
    jhs = [JHll.from_codes(c, 12) for c in (codes, codes2)]
    for h, jh in zip(hs, jhs):
        np.testing.assert_array_equal(h.core, jh.core)
        assert h.report() == jh.report()
    assert hs[0].union_size(hs[1]) == jhs[0].union_size(jhs[1])
    assert hs[0].jaccard(hs[1]) == jhs[0].jaccard(jhs[1])
    np.testing.assert_array_equal(hs[0].merge(hs[1]).core,
                                  jhs[0].merge(jhs[1]).core)
    for m in (5, 32):  # m rounds up to a power of two
        s = SuperMinHashSketch.from_codes(codes, m, device=CPU)
        js = JSmh.from_codes(codes, m)
        assert s.m == js.m and s == SuperMinHashSketch(js.m, js.h)
        s2 = SuperMinHashSketch.from_codes(codes2, m, device=CPU)
        np.testing.assert_array_equal(s.merge(s2).h, js.merge(
            JSmh.from_codes(codes2, m)).h)


def test_sketch_models_file_round_trip(tmp_path):
    kms = np.random.default_rng(2).integers(0, 1 << 62, 900, dtype=np.uint64)
    h = HllSketch.from_kmers(kms, 10, device=CPU)
    s = SuperMinHashSketch.from_kmers(kms, 32, device=CPU)
    h.write(str(tmp_path / "x.hll"))
    s.write(str(tmp_path / "x.smh32"))
    assert HllSketch.from_file(str(tmp_path / "x.hll")) == h
    assert SuperMinHashSketch.from_file(str(tmp_path / "x.smh32")) == s
    assert s == SuperMinHashSketch(32, rm.build_smh_sequential(
        [int(x) for x in kms], 32))


# -- models/bank: the chunked per-genome path ------------------------------

@pytest.mark.parametrize("aux_kind,aux_param", [("smh", 32), ("hll", 6),
                                                (None, None)])
def test_chunked_pieces_equal_single_pass(aux_kind, aux_param):
    """sketch_codes_device with a small piece budget (k-1 overlap, j0 per
    SMH piece, max / unsigned-min merges) equals a one-pass build, as
    tests/test_smh.py:82-116 holds for the JAX package."""
    rng = np.random.default_rng(5)
    codes = np.concatenate([[4], rng.integers(0, 4, 200_000)]).astype(
        np.uint8)
    codes[rng.integers(0, codes.size, 40)] = 4
    regs, aux = tbank.sketch_codes_device(codes, 31, 14, aux_kind, aux_param,
                                          device=CPU, max_chunk=65536)
    kms, valid = kmers.canonical_kmers(codes, 31, CPU)
    zeros = np.zeros(codes.size, np.int32)
    np.testing.assert_array_equal(regs.numpy(), hll_build.hll_build_batch(
        kms, valid, zeros, 14, 1, CPU)[0].numpy())
    if aux_kind == "smh":
        want = smh_build.smh_build_batch(kms, valid, zeros, aux_param, 1, CPU)
        assert torch.equal(aux, want[0])
    elif aux_kind == "hll":
        want = hll_build.hll_build_batch(kms, valid, zeros, aux_param, 1, CPU)
        assert torch.equal(aux, want[0])
    else:
        assert aux is None


def test_chunked_path_tiny_and_empty_genomes():
    """A genome too small to fill every bucket takes the full pass; an
    empty stream gives zero registers and an all-empty SMH."""
    tiny = np.concatenate([[4], np.random.default_rng(8).integers(
        0, 4, 40)]).astype(np.uint8)
    for codes in (tiny, np.zeros(0, np.uint8)):
        regs, aux = tbank.sketch_codes_device(codes, 31, 10, "smh", 32,
                                              device=CPU, max_chunk=16)
        kms, valid = kmers.canonical_kmers(codes, 31, CPU)
        zeros = np.zeros(codes.size, np.int32)
        assert torch.equal(aux, smh_build.smh_build_batch_full(
            kms, valid, zeros, 32, 1, CPU)[0])
        _, complete = smh_build.smh_build_batch_j0(kms, valid, zeros, 32, 1,
                                                   CPU)
        assert bool(complete) == (codes.size == 0)
        assert (u64_numpy(aux) == U64_MAX).all() == (codes.size == 0)
        assert torch.equal(regs, hll_build.hll_build_batch(
            kms, valid, zeros, 10, 1, CPU)[0])
        assert (int(regs.sum()) == 0) == (codes.size == 0)
