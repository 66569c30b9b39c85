"""Inputs of the band-fingerprint tests, made with numpy from a seed: the
CPU tests (tests/test_torch_band_fp.py) hand them to the JAX package and
the port, the card tests (tests/test_torch_kernels_cuda.py) to the kernel
and its plain version. Imports neither JAX nor torch."""

import numpy as np

# (m, n_rows, n_bands): the splits criteria.smh_band_params gives at tau
# 0.5, 0.8 and 0.9 for m = 8, 32, 64, 256 (duplicates once), and the
# (1, m) split it falls back to when no band count reaches its target
SPLITS = sorted({(8, 1, 8), (8, 2, 4), (32, 2, 16), (32, 4, 8), (64, 2, 32),
                 (64, 4, 16), (64, 8, 8), (256, 4, 64), (256, 8, 32),
                 (256, 16, 16), (32, 1, 32), (64, 1, 64), (256, 1, 256)})
# rows of the bank and the tile edge the positions are padded to: not a
# multiple of it
N, TI = 37, 16


def aux_bank(m, seed, n=N):
    """uint64 (n, m) SMH-like words over the whole 64-bit range: words
    with the top bit set (negative as int64), all-ones words and an
    all-ones row, an all-zero row, and rows sharing bands with row 0."""
    rng = np.random.default_rng(seed)
    aux = rng.integers(0, 1 << 64, size=(n, m), dtype=np.uint64)
    aux[1::5] = aux[0]
    aux[2, : m // 2] = aux[0, : m // 2]
    aux[3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    aux[4] = 0
    aux[5:, 0] |= np.uint64(1 << 63)
    aux[6::3, -1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return aux


def plan_layout(aux, seed, ti=TI):
    """The plan's layout of `aux`: (bank, rows, aux_p). bank is aux in its
    own row order with one zero row after it (uint64 (n + 1, m)); rows
    the int32 (n_pad,) map sorted position -> bank row, a shuffled order
    whose padded positions name the zero row; aux_p the host-sorted,
    zero-padded aux the JAX plan fingerprints (uint64 (n_pad, m))."""
    n, m = aux.shape
    n_pad = -(-n // ti) * ti
    order = np.random.default_rng(seed).permutation(n)
    bank = np.zeros((n + 1, m), np.uint64)
    bank[:n] = aux
    rows = np.full(n_pad, n, np.int32)
    rows[:n] = order
    aux_p = np.zeros((n_pad, m), np.uint64)
    aux_p[:n] = aux[order]
    return bank, rows, aux_p


def kernel_model(bank, rows, n_rows, n_bands):
    """numpy model of csrc/band_fp.cu's thread loop: thread t takes
    position t // n_bands and band t % n_bands, reads the band's words of
    its row as 16-byte pairs when n_rows is even (one word at a time when
    odd), and folds each word's low limb, then its high limb."""
    m = bank.shape[1]
    words = bank.reshape(-1)
    out = np.empty(len(rows) * n_bands, np.int32)
    mask = (1 << 32) - 1
    for t in range(len(out)):
        g, b = divmod(t, n_bands)
        base = int(rows[g]) * m + b * n_rows
        h = 2166136261
        step = 2 if n_rows % 2 == 0 else 1
        for j in range(0, n_rows, step):
            for w in words[base + j:base + j + step]:
                h = ((h ^ (int(w) & mask)) * 16777619) & mask
                h = ((h ^ (int(w) >> 32)) * 16777619) & mask
        out[t] = np.uint32(h).view(np.int32)
    return out.reshape(len(rows), n_bands)
