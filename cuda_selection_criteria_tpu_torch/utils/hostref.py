"""Scalar and batched host reference (numpy, true IEEE f64).

Copied from cuda_selection_criteria_tpu/utils/hostref.py: the exact
confirmation every engine ends in. Both packages confirm through the same
f64 operation sequence, so emitted pair sets and Jaccard strings are
identical. The port keeps every criterion's cascade: smh_a, smh_only
(the smh_a band gate without CB), cb, baseline, hll_a and hll_an.
"""

import math

import numpy as np

from ..native import fastx
from ..ops.criteria import smh_band_params, zs_series
from ..ops.estimators import sigma


def histogram(regs):
    c = np.zeros(64, dtype=np.int64)
    vals, cnts = np.unique(np.asarray(regs, np.uint8), return_counts=True)
    c[vals] = cnts
    return c


def ertl_mle_scalar(c, p, relerr=1e-2):
    """Scalar Ertl Algorithm 8 (reference: hll.h:629-688)."""
    q = 64 - p
    m = 1 << p
    if c[q + 1] == m:
        return float("inf")
    k_min = 0
    while c[k_min] == 0:
        k_min += 1
    k_min_p = max(1, k_min)
    k_max = q + 1
    while k_max and c[k_max] == 0:
        k_max -= 1
    k_max_p = min(q, k_max)
    z = 0.0
    for k in range(k_max_p, k_min_p - 1, -1):
        z = 0.5 * z + float(c[k])
    z = math.ldexp(z, -k_min_p)
    c_prime = int(c[q + 1]) + (int(c[k_max_p]) if q else 0)
    a = z + float(c[0])
    m_prime = m - int(c[0])
    g0 = z + math.ldexp(float(c[q + 1]), -q)
    x = m_prime / (0.5 * g0 + a) if g0 <= 1.5 * a else (m_prime / g0) * math.log1p(g0 / a)
    g_prev = 0.0
    delta = x
    eps = relerr / math.sqrt(m)
    while delta > x * eps:
        _, kappa_m1 = math.frexp(x)
        xp = math.ldexp(x, -max(k_max_p + 1, kappa_m1 + 2))
        xp2 = xp * xp
        h = xp - xp2 / 3 + (xp2 * xp2) * (1.0 / 45.0 - xp2 / 472.5)
        for k in range(kappa_m1, k_max_p - 1, -1):
            hp = 1.0 - h
            h = (xp + h * hp) / (xp + hp)
            xp += xp
        g = c_prime * h
        for k in range(k_max_p - 1, k_min_p - 1, -1):
            hp = 1.0 - h
            h = (xp + h * hp) / (xp + hp)
            xp += xp
            g += float(c[k]) * h
        g += x * a
        delta = delta * ((g - m_prime) / (g_prev - g)) if g_prev < g <= m_prime else 0.0
        x += delta
        g_prev = g
    return x * m


def ertl_mle_batch(c, p, relerr=1e-2):
    """Vectorized Ertl Algorithm 8 over a batch of histograms, true IEEE
    f64, bit-identical to ertl_mle_scalar per element (numpy: no FMA
    contraction). c: (B, >= q+2) histogram rows. Returns float64 (B,).
    """
    q = 64 - p
    m = 1 << p
    c = np.ascontiguousarray(np.asarray(c, np.float64)[:, : q + 2])
    nb = c.shape[0]
    if nb == 0:
        return np.zeros(0)
    is_inf = c[:, q + 1] == m

    nz = c > 0
    k_min = np.argmax(nz, axis=1)
    k_min_p = np.maximum(1, k_min)
    k_max = (q + 1) - np.argmax(nz[:, ::-1], axis=1)
    k_max = np.where(nz.any(axis=1), k_max, 0)
    k_max_p = np.minimum(q, k_max)

    z = np.zeros(nb)
    for k in range(q, 0, -1):
        sel = (k >= k_min_p) & (k <= k_max_p)
        z[sel] = 0.5 * z[sel] + c[sel, k]
    z = np.ldexp(z, -k_min_p)
    c_prime = c[:, q + 1].copy()
    if q:
        c_prime += c[np.arange(nb), k_max_p]
    a = z + c[:, 0]
    m_prime = m - c[:, 0]
    g0 = z + np.ldexp(c[:, q + 1], -q)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.where(
            g0 <= 1.5 * a,
            m_prime / (0.5 * g0 + a),
            (m_prime / np.where(g0 > 0, g0, 1.0))
            * np.log1p(g0 / np.where(a > 0, a, 1.0)),
        )
    x = np.where(m_prime == 0, 0.0, x)
    delta_x = x.copy()
    # saturated rows (c[q+1] == m) end as inf regardless; keep them out of
    # the secant loop so the device reject bound's sentinel histograms
    # cost nothing here
    delta_x[is_inf] = 0.0
    eps = relerr / math.sqrt(m)
    g_prev = np.zeros(nb)

    while True:
        act = np.nonzero(delta_x > x * eps)[0]
        if act.size == 0:
            break
        xa = x[act]
        kminp = k_min_p[act]
        kmaxp = k_max_p[act]
        _, kappa_m1 = np.frexp(xa)
        xp = np.ldexp(xa, -np.maximum(kmaxp + 1, kappa_m1 + 2))
        xp2 = xp * xp
        h = xp - xp2 / 3 + (xp2 * xp2) * (1.0 / 45.0 - xp2 / 472.5)
        h_hi = np.maximum(kappa_m1, kmaxp - 1)
        cp = c_prime[act]
        g = np.zeros_like(xa)
        # Fused descending-k loop with per-element masks: h updates for
        # k in [kMinP, max(kappa-1, kMaxP-1)]; g seeded with cPrime*h at
        # the reference's moment (after the k >= kMaxP updates); c[k]*h
        # accumulated for k <= kMaxP-1 (reference: hll.h:667-680).
        with np.errstate(divide="ignore", invalid="ignore"):
            for k in range(int(h_hi.max(initial=0)), 0, -1):
                g = np.where(k == kmaxp - 1, cp * h, g)
                upd = (k <= h_hi) & (k >= kminp)
                hp = 1.0 - h
                h_new = (xp + h * hp) / (xp + hp)
                h = np.where(upd, h_new, h)
                xp = np.where(upd, xp + xp, xp)
                acc = upd & (k <= kmaxp - 1)
                if acc.any():
                    g = np.where(acc, g + c[act, min(k, q + 1)] * h, g)
        g = np.where(kmaxp <= 1, cp * h, g)
        g = g + xa * a[act]
        ok = (g_prev[act] < g) & (g <= m_prime[act])
        with np.errstate(divide="ignore", invalid="ignore"):
            step = np.where(
                ok, delta_x[act] * ((g - m_prime[act]) / (g_prev[act] - g)),
                0.0,
            )
        x[act] = xa + step
        delta_x[act] = step
        g_prev[act] = g
    est = x * m
    est[is_inf] = np.inf
    return est


_hist_scratch = {}
_HIST_BLOCK = 64


def pair_union_histograms_np(regs, ii, kk, block=_HIST_BLOCK):
    """Histograms of max(regs[i], regs[k]) for index-paired rows,
    (B, 64) int64 exact counts: a cache-blocked max-merge + bincount.

    `block` pairs at a time keep the merge and bincount intermediates
    cache-sized. The intermediates live in module-level scratch reused
    across calls, one live shape at a time (single-threaded callers only,
    like the rest of the oracle): per-call allocation faults every page
    in again where the allocator unmaps freed blocks (utils/hostmem). The
    merged array is int64 == intp, so np.bincount reads it without a
    casting copy, and its offsets cannot overflow."""
    nb = len(ii)
    out = np.empty((nb, 64), np.int64)
    if nb == 0:
        return out
    m = regs.shape[1]
    blk = min(block, nb)
    key = (blk, m, regs.dtype)
    s = _hist_scratch.get(key)
    if s is None:
        _hist_scratch.clear()  # one live shape bounds scratch memory
        s = (np.empty((blk, m), regs.dtype), np.empty((blk, m), regs.dtype),
             np.empty((blk, m), np.int64),
             (np.arange(blk, dtype=np.int64) * 64)[:, None])
        _hist_scratch[key] = s
    a, b, w, off = s
    for c0 in range(0, nb, blk):
        nc = min(blk, nb - c0)
        av, bv, wv = a[:nc], b[:nc], w[:nc]
        np.take(regs, ii[c0:c0 + nc], axis=0, out=av)
        np.take(regs, kk[c0:c0 + nc], axis=0, out=bv)
        np.maximum(av, bv, out=av)
        wv[...] = av
        wv += off[:nc]
        out[c0:c0 + nc] = np.bincount(
            wv.ravel(), minlength=nc * 64)[: nc * 64].reshape(nc, 64)
    return out


def hist_backend():
    """The path pair_union_histograms takes in this process: "native" or
    "numpy"."""
    return "native" if fastx.available() else "numpy"


def pair_union_histograms(regs, ii, kk):
    """Histograms of max(regs[i], regs[k]) for index-paired rows, (B, 64)
    int64 exact counts: the native fused gather + max + histogram
    (fastx.pair_union_hist, each register byte read once) when its library
    builds, else pair_union_histograms_np. A register value >= 64 or a row
    index out of range raises ValueError on the native path."""
    regs = np.asarray(regs)
    if regs.dtype == np.uint8 and fastx.available():
        return fastx.pair_union_hist(regs, ii, kk)
    return pair_union_histograms_np(regs, ii, kk)


def report(regs, p):
    """The f64 ERTL-MLE cardinality of one register row (the reference's
    hll report())."""
    return ertl_mle_scalar(histogram(regs), p)


def union_size(regs_a, regs_b, p):
    return ertl_mle_scalar(histogram(np.maximum(regs_a, regs_b)), p)


def smh_a(v1, v2, n_rows, n_bands):
    """Whether some band of n_rows buckets is equal in both vectors: the
    band loop as one compare of the first n_bands * n_rows buckets (a
    band loop of np.array_equal took five times as long a pair)."""
    k = n_bands * n_rows
    eq = np.asarray(v1)[:k] == np.asarray(v2)[:k]
    return bool(eq.reshape(n_bands, n_rows).all(axis=1).any())


class PairOracle:
    """Exact per-pair cascade evaluation on sorted bank arrays, in true
    IEEE f64: the sequential host engine's evaluator and the screened
    engine's confirmation stage.

    hist_fn: optional batched union-histogram provider (ii, kk) ->
    (B, >= q+2) exact integer counts; the screened engine passes the
    device one (parallel/screened.make_device_hist_fn). A device fault
    raises: there is no host fallback.
    """

    SUPPORTED = (None, "smh_a", "smh_only", "cb", "baseline", "hll_a",
                 "hll_an")

    def __init__(self, p, regs, e, aux=None, aux_param=None, criterion=None,
                 tau=0.9, z_score=1.96, order_n=1, apply_cb=True,
                 hist_fn=None):
        if criterion not in self.SUPPORTED:
            raise ValueError(f"unknown criterion {criterion!r}")
        self.p = p
        # regs may be a zero-arg callable resolved on first primary-union
        # touch: with a device-backed hist_fn the host copy is never read
        self._regs = regs
        self.e = e
        self.aux = aux
        self.aux_param = aux_param
        self.criterion = criterion
        self.tau = np.float64(np.float32(tau))
        self.order_n = order_n
        self.apply_cb = apply_cb
        if hist_fn is not None and hasattr(hist_fn, "tau"):
            # a histogram provider with a certain-reject bound above this
            # oracle's threshold would silently lose pairs
            if np.float32(hist_fn.tau) > np.float32(tau):
                raise ValueError(
                    f"hist_fn reject bound tau={hist_fn.tau} exceeds the "
                    f"oracle's tau={tau}; pass the oracle's tau to "
                    "device_hist_fn")
        self.hist_fn = hist_fn or (
            lambda ii, kk: pair_union_histograms(self.regs, ii, kk)
        )
        if criterion in ("smh_a", "smh_only"):
            self.n_rows, self.n_bands = smh_band_params(aux_param, float(tau))
        elif criterion in ("hll_a", "hll_an"):
            self.zs = np.float64(np.float32(z_score)
                                 * np.float32(sigma(aux_param)))

    @property
    def regs(self):
        if callable(self._regs):
            self._regs = self._regs()
        return self._regs

    def gates_pass(self, i, k):
        """Exact pruning cascade up to (excluding) the primary union."""
        e1, e2 = self.e[i], self.e[k]
        if e2 == 0:
            return False
        if self.apply_cb and not (e1 / e2 >= self.tau):
            return False
        crit = self.criterion
        if crit in ("smh_a", "smh_only"):
            if not smh_a(self.aux[i], self.aux[k], self.n_rows, self.n_bands):
                return False
        elif crit == "hll_a":
            t_hat = int(union_size(self.aux[i], self.aux[k], self.aux_param))
            t_hat_mas = t_hat / (1.0 + self.zs)
            k_mas = ((1.0 + e1 / e2) * e2 - t_hat_mas) / t_hat_mas
            if not (k_mas >= self.tau):
                return False
        elif crit == "hll_an":
            t_hat = union_size(self.aux[i], self.aux[k], self.aux_param)
            j_hat = (e1 + e2 - t_hat) / t_hat
            c_corr = (min(1.0, (1.0 + self.zs) * e2 / t_hat)
                      * (1.0 + e1 / e2) * zs_series(self.zs, self.order_n))
            if not (j_hat + c_corr >= self.tau):
                return False
        return True

    def evaluate(self, i, k):
        """Full exact cascade for sorted-pair (i, k): (selected, jacc)."""
        if not self.gates_pass(i, k):
            return False, None
        t = union_size(self.regs[i], self.regs[k], self.p)
        jacc = (self.e[i] + self.e[k] - t) / t
        return (jacc >= self.tau), float(jacc)

    def confirm_pairs(self, pairs, batch=8192):
        """Exact cascade over many candidate pairs: [(i, k, jacc)] for the
        selected ones, in input order. Element-wise the same f64
        operation sequence as evaluate(), vectorized."""
        pairs = list(pairs)
        if not pairs:
            return []
        ii = np.fromiter((i for i, _ in pairs), np.int64, len(pairs))
        kk = np.fromiter((k for _, k in pairs), np.int64, len(pairs))
        e = np.asarray(self.e, np.float64)
        e1 = e[ii]
        e2 = e[kk]

        sel = np.nonzero(e2 != 0)[0]
        if self.apply_cb and sel.size:
            sel = sel[e1[sel] / e2[sel] >= self.tau]
        crit = self.criterion
        if crit in ("smh_a", "smh_only") and sel.size:
            va = self.aux[ii[sel]].reshape(sel.size, self.n_bands,
                                           self.n_rows)
            vb = self.aux[kk[sel]].reshape(sel.size, self.n_bands,
                                           self.n_rows)
            sel = sel[(va == vb).all(axis=2).any(axis=1)]
        elif crit in ("hll_a", "hll_an") and sel.size:
            # batched like the primary union below: at low tau the CB
            # survivors can number in the millions
            keep = []
            for c0 in range(0, sel.size, batch):
                sub = sel[c0:c0 + batch]
                t_hat = ertl_mle_batch(pair_union_histograms(
                    self.aux, ii[sub], kk[sub]), self.aux_param)
                with np.errstate(invalid="ignore"):
                    if crit == "hll_a":
                        # int() of the positive estimate == floor (the
                        # reference's size_t cast)
                        t_hat_mas = np.floor(t_hat) / (1.0 + self.zs)
                        k_mas = ((1.0 + e1[sub] / e2[sub]) * e2[sub]
                                 - t_hat_mas) / t_hat_mas
                        keep.append(sub[k_mas >= self.tau])
                    else:
                        j_hat = (e1[sub] + e2[sub] - t_hat) / t_hat
                        c_corr = (np.minimum(
                            1.0, (1.0 + self.zs) * e2[sub] / t_hat)
                            * (1.0 + e1[sub] / e2[sub])
                            * zs_series(self.zs, self.order_n))
                        keep.append(sub[j_hat + c_corr >= self.tau])
            sel = np.concatenate(keep)

        out = []

        def adjudicate(sub, hists):
            t = ertl_mle_batch(hists, self.p)
            with np.errstate(invalid="ignore", divide="ignore"):
                # t = inf (saturated or sentinel histograms) -> jacc NaN,
                # dropped by the >= tau filter below
                jacc = (e1[sub] + e2[sub] - t) / t
            good = np.nonzero(jacc >= self.tau)[0]
            out.extend(
                (int(ii[sub[g]]), int(kk[sub[g]]), float(jacc[g]))
                for g in good
            )

        subs = [sel[c0:c0 + batch] for c0 in range(0, sel.size, batch)]
        dispatch = getattr(self.hist_fn, "dispatch", None)
        if dispatch is None:
            for sub in subs:
                adjudicate(sub, self.hist_fn(ii[sub], kk[sub]))
            return out
        # Device-backed histograms: keep 2 batches in flight so the host
        # MLE overlaps the device's scan of the next batch.
        pend = []
        for sub in subs:
            pend.append((sub, dispatch(ii[sub], kk[sub])))
            if len(pend) > 2:
                done_sub, handle = pend.pop(0)
                adjudicate(done_sub, self.hist_fn.fetch(handle))
        for done_sub, handle in pend:
            adjudicate(done_sub, self.hist_fn.fetch(handle))
        return out


def select_pairs_host(bank, tau, criterion, z_score=1.96, order_n=1,
                      apply_cb=True):
    """Sequential scalar selection: the control-flow twin of the reference's
    OpenMP loops (sorted rows, CB break, criterion gate, union confirm -
    src/selection.cpp:152-291). Returns [(name_i, name_j, jacc)] in row
    order."""
    cards = bank.cards
    order = np.argsort(cards, kind="stable")
    e = np.trunc(cards[order])
    regs = bank.regs[order]
    aux = bank.aux[order] if bank.aux is not None else None
    names = [bank.names[i] for i in order]

    oracle = PairOracle(
        bank.p, regs, e, aux=aux, aux_param=bank.aux_param,
        criterion=criterion, tau=tau, z_score=z_score, order_n=order_n,
        apply_cb=apply_cb,
    )
    out = []
    n = bank.n
    for i in range(n - 1):
        for k in range(i + 1, n):
            if e[k] == 0:
                continue
            if apply_cb and not (e[i] / e[k] >= oracle.tau):
                break
            selected, jacc = oracle.evaluate(i, k)
            if selected:
                out.append((names[i], names[k], jacc))
    return out
