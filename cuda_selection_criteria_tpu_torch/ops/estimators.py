"""Batched HyperLogLog cardinality estimators. Port of
cuda_selection_criteria_tpu/ops/estimators.py.

* ertl_mle: Ertl's maximum-likelihood estimator (reference:
  sketch/include/sketch/hll.h:629-688) over a batch of register
  histograms. On the card a hand-written kernel (csrc/ertl_mle.cu), one
  thread a row; on the CPU its plain version, a batched loop with
  per-element freeze masks. Both run each element's f64 operation
  sequence of the scalar loop: bit-identical to
  utils/hostref.ertl_mle_batch and to the JAX twin on the CPU away from
  the log1p branch (log1p_branch), where libraries differ by an ulp. The
  dense engines and the aux criteria run it where their histograms lie;
  the screened plan's cardinalities (models/bank.cards_from_hists) run it
  on the card and recompute the log1p-branch rows on the host; the
  screened engine confirms on the host.
* original_estimate: the ORIGINAL estimator the reference's CUDA kernels
  use (include/criteria_sketch_cuda.cuh:30-65), for GPU-parity
  experiments.

Exactness rules that every function here keeps (the kernel keeps the
same with one round-to-nearest intrinsic an operation):
  - one rounding per torch op: the MLE runs eagerly, one kernel per
    multiply and per add (never under torch.compile or through
    addcmul / lerp, which would fuse them into an FMA);
  - division by a constant divides by a tensor on the tensor's device: a
    CUDA tensor divided by a CPU scalar is multiplied by the scalar's
    reciprocal, and `scalar / tensor` is `scalar * reciprocal(tensor)` on
    every device;
  - scaling by 2^e goes through an exact power-of-two table.

Histograms use bins 0..q+1 (q = 64 - p); counts arrays may be longer.
"""

import functools
import math

import numpy as np
import torch

from .screen import _check, _launch

# Exact powers of two for |e| <= 120, far beyond any exponent the
# estimators see; a gather plus one multiply by an exact power of two is
# correctly rounded, identical to C ldexp (also exact in f32 within its
# exponent range).
_POW2_LO = -120
_POW2_HI = 120
_POW2 = np.ldexp(1.0, np.arange(_POW2_LO, _POW2_HI + 1)).astype(np.float64)

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


@functools.lru_cache(maxsize=None)
def _pow2_table(device, dtype):
    return torch.from_numpy(_POW2).to(device=device, dtype=dtype)


def pow2_exact(e, dtype=torch.float64):
    """2.0**e for an integer tensor e, clamped to [-120, 120], exact."""
    idx = e.clamp(_POW2_LO, _POW2_HI).to(torch.int64) - _POW2_LO
    return _pow2_table(e.device, dtype)[idx]


def ldexp_exact(x, e):
    """x * 2^e, correctly rounded (== C ldexp for |e| <= 120)."""
    return x * pow2_exact(e, x.dtype)


def frexp_exponent(x):
    """C frexp's exponent e (x = m * 2^e, m in [0.5, 1)) for positive
    finite x: a log2 guess corrected against exact powers of two. 0 for
    x <= 0, like C's frexp(0); the value for inf and NaN is unspecified
    (the MLE reads it only for elements it then discards)."""
    ok = (x > 0) & torch.isfinite(x)
    xs = torch.where(ok, x, torch.ones_like(x))
    e = torch.floor(torch.log2(xs)).to(torch.int32) + 1
    e = torch.where(xs >= pow2_exact(e, x.dtype), e + 1, e)
    e = torch.where(xs < pow2_exact(e - 1, x.dtype), e - 1, e)
    return torch.where(x > 0, e, 0)


def hll_histogram(regs, p):
    """Register-value histogram c[v] = #{r : regs[r] == v} per row.

    regs: integer tensor (B, m) with values <= q+1 (q = 64 - p), which
    every HLL register satisfies. Returns int64 (B, q+2) exact counts.

    Counted with per-row offsets and one bincount: the JAX twin's one-hot
    (cuda_selection_criteria_tpu/ops/estimators.py:64-74) would
    materialize B x m x (q+2) booleans - 7 GB for one 8192-pair confirm
    chunk at p=14. int32 offsets are exact up to B*(q+2) < 2^31.
    """
    nbins = 64 - p + 2
    b = regs.shape[0]
    off = (torch.arange(b, dtype=torch.int32, device=regs.device)
           * nbins)[:, None]
    flat = (regs.to(torch.int32) + off).reshape(-1)
    return torch.bincount(flat, minlength=b * nbins).reshape(b, nbins)


def make_alpha(m):
    """HLL alpha constant (reference: hll.h:755-762)."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def sigma(p):
    """HLL standard-error table, f32 like the reference
    (include/criteria_sketch.hpp:7-20)."""
    if p == 4:
        v = 1.106 / np.sqrt(np.float64(1 << p))
    elif p == 5:
        v = 1.07 / np.sqrt(np.float64(1 << p))
    elif p == 6:
        v = 1.054 / np.sqrt(np.float64(1 << p))
    elif p == 7:
        v = 1.046 / np.sqrt(np.float64(1 << p))
    else:
        v = 1.039 / np.sqrt(np.float64(1 << p))
    return np.float32(v)


def _secant_eps(relerr, p, dtype):
    """The secant loop's tolerance relerr / sqrt(m), computed in `dtype`
    (a float that `dtype` holds exactly)."""
    np_dt = _NP_DTYPE[dtype]
    return float(np_dt(relerr) / np.sqrt(np_dt(1 << p)))


def _secant_start(counts, p, dtype):
    """The MLE's inputs and secant start, row by row: counts (..., >= q+2)
    as f32 (B, q+2) rows c, and (c, is_inf, k_min_p, k_max_p, c_prime, a,
    m_prime, g0) with the values in `dtype`. Histograms are held f32 (exact
    for counts <= 2^p < 2^24) and each column is widened where it is used,
    as in the JAX twin."""
    q = 64 - p
    m = 1 << p
    c = counts[..., : q + 2].to(torch.float32).reshape(-1, q + 2)
    dev = c.device

    def col(k):
        return c[:, k].to(dtype)

    is_inf = c[:, q + 1] == m
    nz = c > 0
    bins = torch.arange(q + 2, device=dev)
    any_nz = nz.any(1)
    k_min = torch.where(any_nz, torch.where(nz, bins, q + 2).amin(1), 0)
    k_min_p = k_min.clamp(min=1)
    k_max = torch.where(any_nz, torch.where(nz, bins, -1).amax(1), 0)
    k_max_p = k_max.clamp(max=q)

    # z = sum_{k=kMinP..kMaxP} c[k] * 2^-k, accumulated high-to-low like
    # the reference loop (hll.h:671-673); bins outside every row's range
    # change nothing, so the loop walks only the batch's range.
    z = torch.zeros(c.shape[0], dtype=dtype, device=dev)
    lo, hi = torch.stack([k_min_p.amin(), k_max_p.amax()]).tolist()
    for k in range(min(q, hi), max(1, lo) - 1, -1):
        in_range = (k >= k_min_p) & (k <= k_max_p)
        z = torch.where(in_range, 0.5 * z + col(k), z)
    z = ldexp_exact(z, -k_min_p)

    c_prime = col(q + 1)
    if q:
        c_prime = c_prime + c.gather(1, k_max_p[:, None])[:, 0].to(dtype)
    a = z + col(0)
    m_prime = m - col(0)
    g0 = z + col(q + 1) * math.ldexp(1.0, -q)  # exact 2^-q
    return c, is_inf, k_min_p, k_max_p, c_prime, a, m_prime, g0


def log1p_branch(counts, p, dtype=torch.float64):
    """bool (...): whether each histogram's secant start takes the log1p
    branch, g0 > 1.5 a (the branch utils/hostref.ertl_mle_batch takes in
    f64): the rows on which CUDA's, glibc's and SLEEF's log1p may differ by
    an ulp. Plain torch ops on any device; the kernel writes the same flag
    beside its estimates (ertl_mle(..., branch=True))."""
    if counts.shape[:-1].numel() == 0:
        return torch.zeros(counts.shape[:-1], dtype=torch.bool,
                           device=counts.device)
    _, _, _, _, _, a, _, g0 = _secant_start(counts, p, dtype)
    return ~(g0 <= 1.5 * a).reshape(counts.shape[:-1])


def _ertl_mle_plain(counts, p, relerr=1e-2, dtype=torch.float64, work=None):
    """Plain PyTorch version of the MLE kernel (csrc/ertl_mle.cu): every
    row's secant loop as a batched masked loop, one torch op a multiply or
    an add, f64 bit-identical to utils/hostref.ertl_mle_batch away from the
    log1p branch. CPU tensors run it; on the card chip_smoke.py holds the
    kernel against it. work: a dict that, when given, receives the
    operations these rows' loops need (the kernel's bound): "rows",
    "secant_steps" (a row's secant iterations), "update_steps" (inner h / x'
    updates), "acc_steps" (inner g accumulations), "z_steps" (the z loop's
    bins) and "ops", counted as 10 a row, 2 a z bin, 18 a secant step, 6 an
    update and 2 an accumulation."""
    q = 64 - p
    m = 1 << p
    batch_shape = counts.shape[:-1]
    dev = counts.device
    if batch_shape.numel() == 0:
        return torch.zeros(batch_shape, dtype=dtype, device=dev)
    (c, is_inf, k_min_p, k_max_p, c_prime, a, m_prime,
     g0) = _secant_start(counts, p, dtype)

    def col(k):
        return c[:, k].to(dtype)

    def const(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    x = torch.where(g0 <= 1.5 * a, m_prime / (0.5 * g0 + a),
                    (m_prime / g0) * torch.log1p(g0 / a))
    delta_x = x
    eps = _secant_eps(relerr, p, dtype)
    g_prev = torch.zeros_like(x)
    three, d472_5 = const(3.0), const(472.5)
    if work is not None:
        z_steps = int((k_max_p - k_min_p + 1).clamp(min=0).sum())
        work.update(rows=c.shape[0], z_steps=z_steps, secant_steps=0,
                    update_steps=0, acc_steps=0)

    while True:
        active = delta_x > x * eps
        kappa_m1 = frexp_exponent(x)
        h_hi = torch.maximum(kappa_m1, k_max_p - 1)
        # One host read per step: whether any element is still active (the
        # reference's loop test), and the largest h_hi among them. The
        # inner loop of the JAX twin runs k = 64..1 with per-element masks;
        # for k above every active element's h_hi it changes nothing, so
        # starting at that maximum is bit-identical.
        top = int(torch.where(active, h_hi.clamp(min=0) + 1, 0).amax())
        if top == 0:
            break
        if work is not None:
            top_k = h_hi.clamp(max=64)
            upd = (top_k - k_min_p + 1).clamp(min=0)
            acc = (torch.minimum(top_k, k_max_p - 1) - k_min_p + 1).clamp(
                min=0)
            work["secant_steps"] += int(active.sum())
            work["update_steps"] += int(torch.where(active, upd, 0).sum())
            work["acc_steps"] += int(torch.where(active, acc, 0).sum())
        x_prime = ldexp_exact(x, -torch.maximum(k_max_p + 1, kappa_m1 + 2))
        x_pp = x_prime * x_prime
        h = (x_prime - x_pp / three
             + (x_pp * x_pp) * (1.0 / 45.0 - x_pp / d472_5))

        # Fused inner loops (hll.h:667-680): h / x_prime update for k in
        # [kMinP, max(kappa-1, kMaxP-1)] descending; g accumulates c[k]*h
        # for k in [kMinP, kMaxP-1]. The reference computes g = cPrime * h
        # after its first loop (updates for k >= kMaxP), so g is seeded at
        # the start of iteration k = kMaxP-1, or after the loop when
        # kMaxP <= 1 never reaches it.
        g = torch.zeros_like(x)
        for k in range(min(64, top - 1), 0, -1):
            g = torch.where(k == k_max_p - 1, c_prime * h, g)
            upd = (k <= h_hi) & (k >= k_min_p)
            h_prime = 1.0 - h
            h_new = (x_prime + h * h_prime) / (x_prime + h_prime)
            h = torch.where(upd, h_new, h)
            x_prime = torch.where(upd, x_prime + x_prime, x_prime)
            acc = upd & (k <= k_max_p - 1)
            g = torch.where(acc, g + col(min(k, q + 1)) * h, g)
        g = torch.where(k_max_p <= 1, c_prime * h, g)
        g = g + x * a

        # deltaX *= (g - mPrime) / (gprev - g): the division comes first in
        # the reference (hll.h:683)
        step = torch.where((g_prev < g) & (g <= m_prime),
                           delta_x * ((g - m_prime) / (g_prev - g)), 0.0)
        x_new = x + step
        x = torch.where(active, x_new, x)
        delta_x = torch.where(active, step, delta_x)
        g_prev = torch.where(active, g, g_prev)

    if work is not None:
        work["ops"] = (10 * work["rows"] + 2 * work["z_steps"]
                       + 18 * work["secant_steps"]
                       + 6 * work["update_steps"] + 2 * work["acc_steps"])
    est = torch.where(is_inf, math.inf, x * m)
    return est.reshape(batch_shape)


# The histogram element types the kernel reads (csrc/ertl_mle.cu in_kind)
_IN_KIND = {torch.int32: 0, torch.int64: 1, torch.float32: 2}


def ertl_mle(counts, p, relerr=1e-2, dtype=torch.float64, branch=False):
    """Batched Ertl ML cardinality estimate from register histograms.

    counts: (..., >= q+2) register-value histograms (c[0..q+1] used). dtype:
    the compute dtype. float64 is bit-identical to the reference's scalar
    loop away from the log1p branch; float32 is the fast screening mode
    (about 1e-6 relative, covered by the engine's screen margin and host
    adjudication). Every intermediate has the JAX twin's dtype in both.
    branch: also return the bool (...) flags of log1p_branch, computed in
    `dtype`.

    Returns `dtype` (...) estimates (inf where c[q+1] == m), or
    (estimates, flags) with branch.

    CPU tensors of any numeric dtype run _ertl_mle_plain (and
    log1p_branch). A CUDA tensor launches the hand-written kernel
    (csrc/ertl_mle.cu: one thread a row, persistent CTAs whose warps each
    stage 32-row groups in shared memory with every copy in flight at once,
    every operation an explicit round-to-nearest intrinsic) on the current
    stream, or raises; there is no fallback. The kernel reads int32, int64
    or float32 histograms in place: the batch dimensions must merge into
    one row dimension (a contiguous tensor, or a slice of the last
    dimension of one) whose bins are contiguous."""
    who = "ertl_mle"
    q = 64 - p
    _check(who, dtype in _NP_DTYPE, f"compute dtype {dtype}: float64 or "
           "float32")
    _check(who, counts.dim() >= 1 and counts.shape[-1] >= q + 2,
           f"histograms of >= q + 2 = {q + 2} bins expected, got shape "
           f"{tuple(counts.shape)}")
    dev = counts.device
    if dev.type == "cpu":
        est = _ertl_mle_plain(counts, p, relerr, dtype)
        return (est, log1p_branch(counts, p, dtype)) if branch else est
    _check(who, counts.dtype in _IN_KIND, f"int32, int64 or float32 "
           f"histograms expected, got {counts.dtype}")
    _check(who, 2 <= p <= 24, f"p = {p} outside 2..24")
    batch_shape = counts.shape[:-1]
    n = batch_shape.numel()
    try:
        rows = counts.view(n, counts.shape[-1])
    except RuntimeError:
        rows = None
    _check(who, rows is not None, "the batch dimensions of the histograms "
           "do not merge into one row stride (a contiguous tensor or a "
           "slice of its last dimension)")
    stride = rows.stride(0) if n > 1 else counts.shape[-1]
    _check(who, rows.stride(1) == 1 and stride >= q + 2,
           f"bins must be contiguous and rows at least q + 2 = {q + 2} "
           f"elements apart, got strides {tuple(rows.stride())}")
    _check(who, dev.type == "cuda", f"unsupported device {dev}")
    est = torch.empty(batch_shape, dtype=dtype, device=dev)
    flags = (torch.empty(batch_shape, dtype=torch.bool, device=dev)
             if branch else None)
    if n:
        _launch("ertl_mle", dev, rows.data_ptr(), _IN_KIND[counts.dtype], n,
                stride, p, int(dtype == torch.float64),
                _secant_eps(relerr, p, dtype), est.data_ptr(),
                0 if flags is None else flags.data_ptr())
        ertl_mle.launches += 1
    return (est, flags) if branch else est


ertl_mle.launches = 0


def ertl_mle_from_regs(regs, p, relerr=1e-2):
    """f64 cardinality estimates straight from register rows (B, 2^p)."""
    return ertl_mle(hll_histogram(regs, p), p, relerr)


def original_estimate(counts, p):
    """Flajolet ORIGINAL estimator with corrections, batched, f64: raw =
    alpha*m^2 / sum(2^-r), linear counting when raw < 2.5m and zeros > 0,
    large-range correction when raw > 2^32/30
    (include/criteria_sketch_cuda.cuh:30-65)."""
    q = 64 - p
    m = 1 << p
    c = counts[..., : q + 2].to(torch.float64)
    dev = c.device
    zeros = c[..., 0]
    inv_pow2 = torch.from_numpy(np.ldexp(1.0, -np.arange(1, q + 2))).to(dev)
    ssum = zeros + torch.sum(c[..., 1:] * inv_pow2, dim=-1)
    raw = torch.full_like(ssum, make_alpha(m) * m * m) / ssum
    two32 = 2.0 ** 32
    lin = m * torch.log(torch.full_like(zeros, m)
                        / torch.clamp(zeros, min=1.0))
    large = -two32 * torch.log1p(-raw / torch.full_like(raw, two32))
    return torch.where((raw < 2.5 * m) & (zeros > 0), lin,
                       torch.where(raw > two32 / 30.0, large, raw))
