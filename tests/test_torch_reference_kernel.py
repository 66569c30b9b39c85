"""The reference kernel's experiment (cuda_selection_criteria_tpu_torch/
experiments/reference_kernel.py) on the CPU, held against the JAX package:

- pair_list(n) is np.triu_indices(n, 1), the reference's pair order;
- reference_pairs_plain, the plain version of kernel_CBsmh, gives the
  pair set of an oracle built only from JAX functions (smh_band_params
  and smh_a_mask, hll_histogram and original_estimate of the row-wise
  max, cards from the JAX bank's MLE) on banks with planted pairs at J in
  [0.8, 1] (N = 96 and 160, p = 14, SMH m = 32, tau 0.8 and 0.9) and on a
  bank whose aux rows are all equal (every pair reaches the union); J
  within 4 ulp in f64, since torch's and XLA's CPU log may differ by an
  ulp in the linear-counting branch that these genomes take; no J of the
  oracle lies within 1e-9 of tau, so the sets cannot differ by such an
  ulp; the sorted path (plain_lines) gives the same lines;
- the union estimates in the raw branch (no zero register) and the
  large-range branch against JAX original_estimate;
- the kernel's sum of 2^-r in register order equals the histogram's sum
  by value while the union's largest register is at most 39 (every term
  and partial sum is then a multiple of 2^-39 below 2^14, exact in f64):
  the condition under which the card holds the kernel bit-equal to the
  plain version (tests/test_torch_kernels_cuda.py, chip_smoke.py);
- the wrapper, run and main raise without a card; nothing falls back;
- ops/_build.build_probe(src, None, stem) hashes the standalone source
  alone and names no csrc/ file (a stand-in nvcc records its command).
"""

import hashlib
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_banks import one_torch_thread  # noqa: F401

from cuda_selection_criteria_tpu.models.bank import SketchBank as JBank
from cuda_selection_criteria_tpu.ops import criteria as jcriteria
from cuda_selection_criteria_tpu.ops import estimators as jestimators
from cuda_selection_criteria_tpu_torch.experiments import reference_kernel
from cuda_selection_criteria_tpu_torch.models.bank import host_cards
from cuda_selection_criteria_tpu_torch.ops import _build, criteria
from cuda_selection_criteria_tpu_torch.utils import hostmem, synth

pytestmark = pytest.mark.usefixtures("one_torch_thread")
P = 14
M = 32
JAX_CHUNK = 64  # pairs a JAX union step (a one-hot of 64 x 2^14 x 52)


def planted_bank(n, seed, n_pairs, aux_equal=False):
    """(regs uint8 (n, 2^14), aux uint64 (n, 32)) of n genomes of
    256-32768 uniform hashes (log-uniform), as utils/synth.planted_file_banks
    draws them, with n_pairs genomes sharing a share of their predecessor's
    hashes for a true Jaccard drawn in [0.8, 1] and its SMH row; every aux
    row row 0's with aux_equal."""
    rng = np.random.default_rng(seed)
    items = np.exp(rng.uniform(np.log(256), np.log(32768), n)).astype(
        np.int64)
    h = rng.integers(0, 1 << 64, size=(n, int(items.max())), dtype=np.uint64)
    aux = synth.synthetic_aux(n, M, rng)
    for i in np.sort(rng.choice(n - 1, size=n_pairs, replace=False)):
        j = rng.uniform(0.8, 1.0)
        items[i + 1] = items[i]
        shared = int(round(2 * items[i] * j / (1 + j)))
        h[i + 1, :shared] = h[i, :shared]
        aux[i + 1] = aux[i]
    if aux_equal:
        aux[:] = aux[0]
    valid = np.arange(h.shape[1])[None, :] < items[:, None]
    return synth._reduce_hashes(h, valid, P), aux


def jax_unions(regs, i, k):
    """f64 ORIGINAL estimates of the unions of rows i and k, by the JAX
    package's hll_histogram and original_estimate, JAX_CHUNK pairs a step
    (the last one padded, so one shape is compiled)."""
    out = []
    for c0 in range(0, len(i), JAX_CHUNK):
        a, b = i[c0:c0 + JAX_CHUNK], k[c0:c0 + JAX_CHUNK]
        pad = JAX_CHUNK - len(a)
        a, b = np.pad(a, (0, pad), mode="edge"), np.pad(b, (0, pad),
                                                         mode="edge")
        u = jnp.maximum(jnp.asarray(regs[a]), jnp.asarray(regs[b]))
        est = jestimators.original_estimate(jestimators.hll_histogram(u, P),
                                            P)
        out.append(np.asarray(est)[:JAX_CHUNK - pad])
    return np.concatenate(out) if out else np.zeros(0)


def jax_oracle(regs, aux, tau):
    """(i, k, J f64, every computed J): the reference kernel's pairs over
    the triangle from JAX functions alone; cards from the JAX bank's MLE."""
    n = len(regs)
    cards = JBank(names=[f"g{i}" for i in range(n)], regs=regs, p=P,
                  aux_kind="smh", aux=aux, aux_param=M).cards
    n_rows, n_bands = jcriteria.smh_band_params(M, tau)
    gate = np.asarray(jcriteria.smh_a_mask(jnp.asarray(aux), jnp.asarray(aux),
                                           n_rows, n_bands))
    i, k = np.triu_indices(n, 1)
    i, k = i[gate[i, k]], k[gate[i, k]]
    t = jax_unions(regs, i, k)
    j = (cards[i] + cards[k] - t) / t
    keep = np.isfinite(j) & (j >= jcriteria.effective_tau(tau))
    return i[keep], k[keep], j[keep], j


def port_plain(regs, aux, tau, dtype=torch.float64):
    """reference_pairs_plain over pair_list(n) of the unsorted bank, cards
    from the port's host MLE."""
    n_rows, n_bands = criteria.smh_band_params(M, tau)
    i, k, j = reference_kernel.reference_pairs_plain(
        torch.from_numpy(regs), torch.from_numpy(aux.view(np.int64)),
        torch.from_numpy(host_cards(regs, P)), tau, n_rows, n_bands,
        torch.from_numpy(reference_kernel.pair_list(len(regs))), dtype)
    return i.numpy(), k.numpy(), j.numpy()


@pytest.mark.parametrize("n", [1, 2, 3, 257])
def test_pair_list_is_the_upper_triangle(n):
    got = reference_kernel.pair_list(n)
    i, k = np.triu_indices(n, 1)
    assert got.dtype == np.int32 and got.shape == (len(i), 2)
    np.testing.assert_array_equal(got[:, 0], i)
    np.testing.assert_array_equal(got[:, 1], k)


BANKS = {  # name -> (n, seed, planted pairs, aux_equal)
    "planted96": (96, 96, 24, False),
    "planted160": (160, 160, 40, False),
    "aux_equal64": (64, 64, 12, True),
}


@pytest.mark.parametrize("tau", [0.8, 0.9])
@pytest.mark.parametrize("name", list(BANKS))
def test_plain_matches_jax_oracle(name, tau):
    n, seed, n_pairs, aux_equal = BANKS[name]
    regs, aux = planted_bank(n, seed, n_pairs, aux_equal)
    wi, wk, wj, every = jax_oracle(regs, aux, tau)
    # the premise: no J within 1e-9 of tau, so an ulp cannot move a pair
    assert np.all(np.abs(every[np.isfinite(every)]
                         - jcriteria.effective_tau(tau)) > 1e-9)
    assert len(wi) >= n_pairs // 4  # planted pairs above tau
    if aux_equal:
        assert len(every) == n * (n - 1) // 2  # every pair took the union
    gi, gk, gj = port_plain(regs, aux, tau)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gk, wk)
    assert np.all(np.abs(gj - wj) <= 4 * np.spacing(np.abs(wj)))

    li, lk, ls = reference_kernel.plain_lines(regs, aux, host_cards(regs, P),
                                              tau, device="cpu")
    np.testing.assert_array_equal(li, gi)
    np.testing.assert_array_equal(lk, gk)
    assert ls.dtype == np.float32
    np.testing.assert_array_equal(ls, gj.astype(np.float32))


def _branch_rows(lo, hi, seed, n=8):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi + 1, size=(n, 1 << P), dtype=np.uint8)


@pytest.mark.parametrize("branch,lo,hi", [("raw", 1, 12),
                                          ("large_range", 14, 17)])
def test_union_branches_match_jax(branch, lo, hi):
    regs = _branch_rows(lo, hi, 7 if branch == "raw" else 8)
    a, b = np.arange(0, 8, 2), np.arange(1, 8, 2)
    u = np.maximum(regs[a], regs[b])
    m = 1 << P
    raw = (jestimators.make_alpha(m) * m * m
           / np.ldexp(1.0, -u.astype(np.int64)).sum(1))
    assert np.all(u > 0)  # no zero register: linear counting is not taken
    if branch == "raw":
        assert np.all((raw >= 2.5 * m) & (raw <= 2.0 ** 32 / 30.0))
    else:
        assert np.all((raw > 2.0 ** 32 / 30.0) & (raw < 2.0 ** 32))
    got = reference_kernel.union_cards(torch.from_numpy(regs),
                                       torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()
    want = jax_unions(regs, a, b)
    if branch == "raw":
        np.testing.assert_array_equal(got, want)
    else:  # -2^32 log1p(-raw / 2^32): torch's and XLA's log1p, an ulp apart
        assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))
        assert not np.allclose(want, raw, rtol=1e-3)  # the correction acts


def test_register_order_sum_is_the_histogram_sum():
    regs, _ = planted_bank(96, 5, 24)
    a, b = np.triu_indices(96, 1)
    a, b = a[::17], b[::17]
    u = np.maximum(regs[a], regs[b]).astype(np.int64)
    assert u.max() <= 39  # the condition: every term a multiple of 2^-39
    # the kernel: 2^-r added one register after another (cumsum is serial)
    serial = np.cumsum(np.ldexp(1.0, -u), axis=1)[:, -1]
    # the plain version: counts x 2^-r summed by value
    hist = np.stack([np.bincount(row, minlength=52) for row in u])
    by_value = hist[:, 0] + (hist[:, 1:] * np.ldexp(1.0, -np.arange(1, 52))
                             ).sum(1)
    np.testing.assert_array_equal(serial, by_value)
    assert np.all(serial == np.array([np.sum(np.ldexp(1.0, -row))
                                      for row in u[:, ::-1]]))


def test_wrapper_raises_off_the_card(monkeypatch):
    regs, aux = planted_bank(8, 3, 2)
    cards = host_cards(regs, P)
    with pytest.raises(ValueError, match="CUDA card only"):
        reference_kernel.reference_pairs(regs, aux, cards, 0.9, device="cpu")
    with pytest.raises(ValueError, match="CUDA card only"):
        reference_kernel.prepare(regs, aux, cards, 0.9, device="cpu")
    with pytest.raises(ValueError, match="CUDA card only"):
        reference_kernel.run(8, device="cpu")
    # the shapes are checked before the device
    with pytest.raises(ValueError, match="uint8 rows"):
        reference_kernel.prepare(regs[:, :64], aux, cards, 0.9, "cpu")
    with pytest.raises(ValueError, match="aux must be uint64"):
        reference_kernel.prepare(regs, aux[:4], cards, 0.9, "cpu")
    with pytest.raises(ValueError, match="aux must be uint64"):
        reference_kernel.prepare(regs, aux.view(np.int64), cards, 0.9, "cpu")
    if not torch.cuda.is_available():
        monkeypatch.setattr(hostmem, "enable_arena_reuse", lambda: None)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            reference_kernel.main(["--n", "8"])


def _fake_nvcc(tmp_path, rc=0):
    """A stand-in nvcc that records its arguments and writes its -o file."""
    log = tmp_path / "nvcc_args.txt"
    path = tmp_path / "nvcc"
    path.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=\"$a\"; prev=\"$a\"; "
        "done\n"
        f"[ {rc} -eq 0 ] || {{ echo 'error: broken' ; exit {rc}; }}\n"
        "echo built > \"$out\"\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path), log


def test_build_probe_standalone_source(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "CSRC", str(tmp_path / "no_csrc"))
    src = tmp_path / "probe.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    path, _, _ = _build.build_probe(str(src), None, "probe")
    sha = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    assert os.path.basename(path) == f"libprobe_{sha}.so"
    assert os.path.exists(path)
    args = log.read_text().split()
    assert str(src) in args and "arch=compute_90a,code=sm_90a" in args
    assert not any("csrc" in a for a in args)
    assert _build.build_probe(str(src), None, "probe") == (path, 0.0, "")

    src.write_text("extern \"C\" int f() { return 1; }\n")
    path2, _, _ = _build.build_probe(str(src), None, "probe")
    assert path2 != path and os.path.exists(path2)
    assert len(log.read_text().splitlines()) == 2  # built twice, not thrice

    ref, _, _ = reference_kernel.build()
    with open(reference_kernel.SOURCE, "rb") as fh:
        sha = hashlib.sha1(fh.read()).hexdigest()[:12]
    assert os.path.basename(ref) == f"libreference_kernel_{sha}.so"


def test_build_probe_raises_when_nvcc_fails(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, rc=2)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "probe.cu"
    src.write_text("broken\n")
    with pytest.raises(RuntimeError, match="nvcc failed for probe.cu"):
        _build.build_probe(str(src), None, "probe")


def test_bench_bank_seed():
    """run(seed=) draws the bench bank's law from another seed; the
    default seed is the bench's own bank."""
    regs, aux, e = synth.bench_bank(64)
    same = synth.bench_bank(64, seed=synth.BENCH_SEED)
    other = synth.bench_bank(64, seed=1)
    for a, b in zip((regs, aux, e), same):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(regs, other[0])
    assert other[0].shape == regs.shape and other[1].shape == aux.shape
