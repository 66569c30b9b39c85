"""SketchBank: stacked sketch arrays for the all-pairs selection engine,
and the build path that makes them from FASTA/FASTQ files.

Host numpy, like cuda_selection_criteria_tpu/models/bank.py: registers
(N, 2^p) uint8, aux sketches stacked, cardinalities from the host f64
ERTL-MLE over the row histograms. A bank made without cardinalities
computes them at their first read (host_cards: the row histograms of a
native threaded pass), unless the screened engine has set them first: its
plan (parallel/screened.ScreenPlan) uploads the registers to the device
itself, takes the row histograms there from the same pass that finds
the present values, and the MLE of them on the card (cards_from_hists).
build_bank_from_files decodes the files on
host threads and builds the sketches on the device with torch ops
(ops/kmers, ops/hll_build, ops/smh_build), or on the host with the native
single-pass builder (backend="native"). The sketch-file loaders read
through the native threaded batch readers, or numpy where the native
library does not build.
"""

import glob
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..native import fastx as native
from ..ops import estimators, hll_build, smh_build
from ..ops.hashes import umin, wang_hash64
from ..ops.kmers import canonical_kmers
from ..utils import fasta, formats
from ..utils.device import resolve
from ..utils.hostref import ertl_mle_batch
from .smh import vecsize

PRIMARY_P = 14  # reference hardcodes p=14 for the primary sketch
DEFAULT_K = 31  # reference hardcodes k=31 (src/build_sketch.cpp:190)

PACK_GENOMES = 64  # genomes per packed device pass
PACK_CODES = 1 << 22  # code budget of one pack
MAX_CHUNK = 1 << 24  # piece budget of the per-genome chunked path
# SuperMinHash candidates materialize (codes, m) int64 values on the
# device: cap codes * m near 2^26 (512 MiB per candidate array).
SMH_CANDIDATES = 1 << 26


def _ctz(x):
    return (x & -x).bit_length() - 1


# Rows an ertl_mle_batch call takes in mle_rows. The MLE's secant loop is
# masked row by row, so a row's card does not depend on its batch: a bank
# above this size is split into chunks of it, run on min(8, cores) threads
# (numpy releases the interpreter lock inside each array operation), and
# the results concatenated. A chunk's array operations stay long enough
# that each call's Python overhead is small, and a bank of 2^19 rows gives
# the threads 16 chunks to share.
MLE_CHUNK = 1 << 15


def _row_hists_numpy(regs):
    """(N, 64) int64 register histograms of a uint8 (N, m) bank, 2048 rows
    a bincount (a whole-bank offset array would be a temporary of 8 bytes
    a register): the plain version of fastx.row_hist, and host_cards'
    route where the native library does not build."""
    hists = np.zeros((regs.shape[0], 64), np.int64)
    for g0 in range(0, regs.shape[0], 2048):
        sub = regs[g0:g0 + 2048].astype(np.int32)
        sub += (np.arange(sub.shape[0], dtype=np.int32) * 64)[:, None]
        hists[g0:g0 + 2048] = np.bincount(
            sub.ravel(), minlength=sub.shape[0] * 64).reshape(-1, 64)
    return hists


def host_cards(regs, p):
    """f64 ERTL-MLE cardinality per register row, bit-identical to the
    reference's scalar report() (utils/hostref.ertl_mle_batch). The row
    histograms come from the native threaded pass (fastx.row_hist, each
    register read once on min(8, cores) threads), or from
    _row_hists_numpy where the native library does not build; the MLE
    runs over MLE_CHUNK-row chunks on as many threads."""
    hists = (native.row_hist(regs) if native.available()
             else _row_hists_numpy(regs))
    return mle_rows(hists, p)


def mle_rows(hists, p):
    """ertl_mle_batch of (N, 64) histograms, over MLE_CHUNK-row chunks on
    min(8, cores) threads above MLE_CHUNK rows: the same bits."""
    if len(hists) <= MLE_CHUNK:
        return ertl_mle_batch(hists, p)
    starts = range(0, len(hists), MLE_CHUNK)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return np.concatenate(list(pool.map(
            lambda c0: ertl_mle_batch(hists[c0:c0 + MLE_CHUNK], p),
            starts)))


def cards_from_hists(hists, p):
    """f64 ERTL-MLE cardinalities of (N, >= q+2) register histograms where
    they lie (the device branch of the JAX SketchBank.compute_cards),
    bit-equal to host_cards of the same rows: (float64 (N,) numpy array,
    the number of rows the host recomputed).

    estimators.ertl_mle computes every row in f64 with its flag of the
    log1p branch (on the card the kernel csrc/ertl_mle.cu), and only the
    estimates and the flags come to the host. The flagged rows, whose
    secant start calls log1p, where CUDA's, glibc's and SLEEF's differ by
    an ulp, are computed again by hostref.ertl_mle_batch over their own
    histograms: the cards feed the sort and the reference's size_t
    truncation, so every bit counts. Bank rows of real genomes have zero
    registers and take no log1p."""
    est, branch = estimators.ertl_mle(hists, p, branch=True)
    cards = est.cpu().numpy()
    rows = np.flatnonzero(branch.cpu().numpy())
    if rows.size:
        idx = torch.from_numpy(rows).to(hists.device)
        cards[rows] = ertl_mle_batch(hists[idx].cpu().numpy(), p)
    return cards, int(rows.size)


@dataclass
class SketchBank:
    """Stacked sketches for N genomes.

    Attributes:
      names: list of genome file paths (identity for output lines).
      regs: uint8 (N, 2^p) primary HLL registers.
      p: primary precision (14).
      cards: float64 (N,) ERTL-MLE cardinalities (host f64). None at
        construction leaves them unknown: the first read computes them
        (host_cards), unless something has set them before (the screened
        plan does, from the device's row histograms; has_cards says
        whether they are known).
      aux_kind: None | "hll" | "smh".
      aux: uint8 (N, 2^p_aux) HLL registers, or uint64 (N, m) SMH buckets.
      aux_param: p_aux for "hll", m for "smh".
    """

    names: list
    regs: np.ndarray
    p: int = PRIMARY_P
    cards: np.ndarray = None
    aux_kind: str = None
    aux: np.ndarray = None
    aux_param: int = None

    def has_cards(self):
        """Whether the cardinalities are known without computing them."""
        return self._cards is not None

    @property
    def n(self):
        return len(self.names)

    @classmethod
    def from_arrays(cls, names, regs, p=PRIMARY_P, cards=None, aux=None,
                    aux_kind=None, aux_param=None):
        """The port's bank from a reference SketchBank's numpy fields
        (names, regs, p, cards, aux, aux_kind, aux_param): state carried
        across from the JAX package. cards=None leaves them to be
        computed: by the screened plan on the device, or by host_cards (the
        native threaded row histograms, then the host f64 MLE over row
        chunks on host threads) at their first read."""
        return cls(
            names=list(names),
            regs=np.ascontiguousarray(regs, np.uint8),
            p=int(p),
            cards=None if cards is None else np.asarray(cards, np.float64),
            aux_kind=aux_kind,
            aux=None if aux is None else np.asarray(aux),
            aux_param=aux_param,
        )

    @classmethod
    def from_sketch_files(cls, files, criterion=None, aux_bytes=256,
                          io_threads=16):
        """Load .hll (+ .hll_{p_aux} / .smh{m}) files like the reference's
        selection binaries (src/selection.cpp:122-256): hll_a / hll_an read
        the aux HLL at p_aux = ctz(aux_bytes), smh_a the SMH of
        aux_bytes / 8 buckets.

        Reads on `io_threads` threads with the native batch readers
        (the reference reads one gz file per genome per sketch on one
        thread), or with the numpy readers of utils/formats where the
        native library does not build: the same bytes either way."""
        if criterion not in (None, "smh_a", "hll_a", "hll_an"):
            raise NotImplementedError(
                f"loading aux sketches for {criterion!r} is not ported yet "
                "(ROADMAP.md queue 1)")
        regs = load_hll_bank([f + ".hll" for f in files], PRIMARY_P,
                             io_threads)
        aux_kind = aux = aux_param = None
        if criterion in ("hll_a", "hll_an"):
            p_aux = _ctz(aux_bytes)
            aux = load_hll_bank([f + f".hll_{p_aux}" for f in files], p_aux,
                                io_threads)
            aux_kind, aux_param = "hll", p_aux
        elif criterion == "smh_a":
            m = aux_bytes // 8
            aux = load_smh_bank([f + f".smh{m}" for f in files], m,
                                io_threads)
            aux_kind, aux_param = "smh", m
        return cls(names=list(files), regs=regs, aux_kind=aux_kind, aux=aux,
                   aux_param=aux_param)

    def sorted_by_cardinality(self):
        """Ascending-cardinality order used by the selection engine;
        mirrors src/selection.cpp:144-149."""
        return np.argsort(self.cards, kind="stable")

    def write_sketch_files(self):
        """Persist next to the FASTA files, reference formats/suffixes."""
        for i, name in enumerate(self.names):
            formats.write_hll(name + ".hll", self.p, self.regs[i])
            if self.aux_kind == "hll":
                formats.write_hll(name + f".hll_{self.aux_param}",
                                  self.aux_param, self.aux[i])
            elif self.aux_kind == "smh":
                formats.write_smh(name + f".smh{self.aux_param}",
                                  self.aux[i])

    def save(self, path, shards=1):
        """Write the whole bank as `shards` row-partitioned npz files, the
        JAX package's bank checkpoint (one or a few flat arrays instead of
        one gz file per genome per sketch)."""
        bounds = np.linspace(0, self.n, shards + 1, dtype=np.int64)
        for s in range(shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            fn = (_norm_npz(path) if shards == 1
                  else f"{path}.shard{s:04d}-of-{shards:04d}.npz")
            payload = {
                "names": np.array(self.names[lo:hi]),
                "regs": self.regs[lo:hi],
                "p": np.int64(self.p),
                "cards": self.cards[lo:hi],
                "aux_kind": np.array(self.aux_kind or ""),
                "aux_param": np.int64(self.aux_param or 0),
                "n_shards": np.int64(shards),
                "shard": np.int64(s),
            }
            if self.aux is not None:
                payload["aux"] = self.aux[lo:hi]
            np.savez_compressed(fn, **payload)

    @classmethod
    def load(cls, path):
        """Load a bank written by save(); accepts the base path of a
        sharded set and reassembles every shard in order. A shard set must
        agree on n_shards and hold each index 0..n_shards-1 exactly once,
        so stale shards of an earlier save raise instead of silently
        joining the bank."""
        paths = [path]
        if not os.path.exists(path):
            if os.path.exists(_norm_npz(path)):
                paths = [_norm_npz(path)]
            else:
                paths = sorted(glob.glob(path + ".shard*-of-*"))
                if not paths:
                    raise FileNotFoundError(path)
        parts = [np.load(f, allow_pickle=False) for f in paths]
        if len(parts) > 1 or int(parts[0]["n_shards"]) > 1:
            n_shards = int(parts[0]["n_shards"])
            seen = {}
            for f, z in zip(paths, parts):
                if int(z["n_shards"]) != n_shards:
                    raise ValueError(
                        f"inconsistent shard set at {path!r}: {f} has "
                        f"n_shards={int(z['n_shards'])}, expected {n_shards} "
                        "(stale shards from an earlier save?)")
                s = int(z["shard"])
                if s in seen:
                    raise ValueError(
                        f"duplicate shard {s} at {path!r}: {seen[s]} and {f}")
                seen[s] = f
            if sorted(seen) != list(range(n_shards)):
                raise ValueError(
                    f"incomplete shard set at {path!r}: have {sorted(seen)}, "
                    f"expected 0..{n_shards - 1}")
            parts = sorted(parts, key=lambda z: int(z["shard"]))
        return cls(
            names=[str(x) for z in parts for x in z["names"]],
            regs=np.concatenate([z["regs"] for z in parts]),
            p=int(parts[0]["p"]),
            cards=np.concatenate([z["cards"] for z in parts]),
            aux_kind=str(parts[0]["aux_kind"]) or None,
            aux=(np.concatenate([z["aux"] for z in parts])
                 if "aux" in parts[0] else None),
            aux_param=int(parts[0]["aux_param"]) or None,
        )


def _get_cards(bank):
    if bank._cards is None:
        bank._cards = host_cards(bank.regs, bank.p)
    return bank._cards


def _set_cards(bank, cards):
    bank._cards = cards


# The dataclass's `cards` field (its __init__ argument) becomes a property
# over _cards: the default None is read by __init__ at class creation, and
# the assignment there goes through the setter.
SketchBank._cards = None
SketchBank.cards = property(_get_cards, _set_cards)


def load_hll_bank(paths, p, io_threads=16):
    """Stacked uint8 (N, 2^p) registers from .hll files: the native
    threaded batch reader on `io_threads` threads, or the numpy reader
    where the native library does not build or the batch reader refuses a
    file (a missing one, or one of another p: the numpy reader then
    raises or reads it as it is, as the JAX package's loader does)."""
    if native.available():
        try:
            return native.read_hll_batch(paths, p, threads=io_threads)
        except IOError:
            pass
    return np.stack([formats.read_hll(f)[1] for f in paths])


def load_smh_bank(paths, m, io_threads=16):
    """Stacked uint64 (N, m) SuperMinHash buckets from .smh{m} files, read
    like load_hll_bank (a file of another bucket count goes to the numpy
    reader)."""
    if native.available():
        try:
            return native.read_smh_batch(paths, m, threads=io_threads)
        except IOError:
            pass
    return np.stack([formats.read_smh(f) for f in paths])


def _norm_npz(path):
    """np.savez appends .npz when missing; normalize so save(p)/load(p)
    agree for any p."""
    return path if path.endswith(".npz") else path + ".npz"


def aux_spec(criterion, aux_bytes):
    """(aux_kind, aux_param) that build_sketch -c/-a give: the aux HLL at
    p_aux = ctz(bytes) for hll_a / hll_an, SuperMinHash with
    vecsize(bytes / 8) buckets for smh_a (src/build_sketch.cpp:242-274)."""
    if criterion in ("hll_a", "hll_an"):
        return "hll", _ctz(aux_bytes)
    if criterion == "smh_a":
        return "smh", vecsize(aux_bytes // 8)
    return None, None


def sketch_codes_device(codes, k, p, aux_kind=None, aux_param=None,
                        device=None, max_chunk=None):
    """(primary regs, aux sketch) of one genome from its code stream, as
    device tensors (uint8 registers; int64 SuperMinHash buckets).

    One upload, then pieces of at most `max_chunk` codes with k-1 overlap,
    so windows spanning piece boundaries are computed exactly once; the
    per-piece sketches merge by max (HLL) and unsigned min (SMH). Each SMH
    piece takes the j=0 pass and falls back to the full Fisher-Yates pass
    only when that piece leaves a bucket unhit: j=0 candidates always beat
    j>0 ones, so a complete piece's minima are its exact minima, and
    minima compose across pieces. The pieces are not padded (the JAX
    package pads them to bound recompiles; sentinel padding cannot change
    a sketch)."""
    dev = resolve(device)
    codes = np.asarray(codes, np.uint8)
    if max_chunk is None:
        max_chunk = MAX_CHUNK
        if aux_kind == "smh":
            max_chunk = min(max_chunk, max(1 << 12,
                                           SMH_CANDIDATES // aux_param))
    n = codes.size
    d_codes = torch.from_numpy(codes).to(dev)
    regs = aux = None
    pos = 0
    while pos == 0 or pos < n:
        piece = d_codes[max(0, pos - (k - 1)):pos + max_chunk]
        pos += max_chunk
        kms, valid = canonical_kmers(piece, k, dev)
        hashed = wang_hash64(kms, dev)
        zeros = torch.zeros(kms.shape, dtype=torch.int64, device=dev)
        r = hll_build.hll_build_hashed(hashed, valid, zeros, p, 1)[0]
        regs = r if regs is None else torch.maximum(regs, r)
        if aux_kind == "hll":
            a = hll_build.hll_build_hashed(hashed, valid, zeros, aux_param,
                                           1)[0]
            aux = a if aux is None else torch.maximum(aux, a)
        elif aux_kind == "smh":
            a, complete = smh_build.smh_build_batch_j0(
                kms, valid, zeros, aux_param, 1, dev)
            if not bool(complete):
                a = smh_build.smh_build_batch_full(kms, valid, zeros,
                                                   aux_param, 1, dev)
            aux = a[0] if aux is None else umin(aux, a[0])
        if n == 0:
            break
    return regs, aux


def _expand_gids(offsets, n):
    """Per-position genome ids (int64 (n,)) from a pack's (PACK_GENOMES+1,)
    cumulative start offsets, on their device. Positions past the last
    genome clip to the last id."""
    pos = torch.arange(n, dtype=torch.int64, device=offsets.device)
    gids = torch.searchsorted(offsets[1:], pos, right=True)
    return gids.clamp_(0, PACK_GENOMES - 1)


def _pack_pipeline(codes, offsets, k, p, aux_kind, aux_param):
    """One device pass over a pack: (regs uint8 (PACK_GENOMES, 2^p), aux,
    smh_complete), all left on the device; smh_complete is None unless
    aux_kind is "smh" (then the j=0 pass's flag, not yet fetched)."""
    dev = codes.device
    gids = _expand_gids(offsets, codes.shape[0])
    kms, valid = canonical_kmers(codes, k, dev)
    hashed = wang_hash64(kms, dev)
    regs = hll_build.hll_build_hashed(hashed, valid, gids, p, PACK_GENOMES)
    aux = complete = None
    if aux_kind == "hll":
        aux = hll_build.hll_build_hashed(hashed, valid, gids, aux_param,
                                         PACK_GENOMES)
    elif aux_kind == "smh":
        aux, complete = smh_build.smh_build_batch_j0(
            kms, valid, gids, aux_param, PACK_GENOMES, dev)
    return regs, aux, complete


def _pack_smh_full(codes, offsets, k, m):
    """The exact full SuperMinHash pass over a pack whose j=0 pass left a
    bucket unhit."""
    kms, valid = canonical_kmers(codes, k, codes.device)
    return smh_build.smh_build_batch_full(
        kms, valid, _expand_gids(offsets, codes.shape[0]), m, PACK_GENOMES,
        codes.device)


def _pack_arrays(pack):
    """A pack's code streams concatenated, and its (PACK_GENOMES + 1,)
    int64 offsets (offsets[g] = first position of genome g; the empty
    tail slots share the final boundary). Every stream begins with a reset
    sentinel (the FASTA reader emits a leading boundary), so no k-mer
    window spans two genomes."""
    codes = np.concatenate([c for _, c in pack])
    offsets = np.zeros(PACK_GENOMES + 1, np.int64)
    offsets[1:len(pack) + 1] = np.cumsum([len(c) for _, c in pack])
    offsets[len(pack) + 1:] = offsets[len(pack)]
    return codes, offsets


def _launch_pack(pack, k, p, aux_kind, aux_param, dev):
    """Upload a pack and enqueue its device pass: (codes, offsets, regs,
    aux, smh_complete) device tensors."""
    codes, offsets = _pack_arrays(pack)
    d_codes = torch.from_numpy(codes).to(dev)
    d_off = torch.from_numpy(offsets).to(dev)
    return (d_codes, d_off) + _pack_pipeline(d_codes, d_off, k, p, aux_kind,
                                             aux_param)


def _sketch_pack_device(pack, k, p, aux_kind, aux_param, device=None):
    """Sketch up to PACK_GENOMES genomes [(file index, codes)] in one
    device pass (k-mers, hashes, both scatters and the SMH j=0 pass), the
    rare j=0-incomplete pack through the exact full pass: (regs, aux)
    device tensors with one row per pack slot."""
    d_codes, d_off, regs, aux, complete = _launch_pack(
        pack, k, p, aux_kind, aux_param, resolve(device))
    if complete is not None and not bool(complete):
        aux = _pack_smh_full(d_codes, d_off, k, aux_param)
    return regs, aux


def _decode(path):
    t0 = time.perf_counter()
    codes = fasta.fasta_codes(path)
    return codes, time.perf_counter() - t0


def _decoded(files, threads):
    """(codes, decode seconds) of each file in order, decoded on `threads`
    threads at most 2 * threads files ahead of the caller, so a corpus of
    10^5 genomes is never all in memory at once."""
    pool = ThreadPoolExecutor(max_workers=threads)
    ahead = deque()
    try:
        todo = iter(files)
        for f in todo:
            ahead.append(pool.submit(_decode, f))
            if len(ahead) == 2 * threads:
                break
        while ahead:
            done = ahead.popleft()
            f = next(todo, None)
            if f is not None:
                ahead.append(pool.submit(_decode, f))
            yield done.result()
    finally:
        pool.shutdown(cancel_futures=True)


def _build_bank_native(files, aux_kind, aux_param, k, io_threads, st):
    """The native single-pass host builder (native/fastx.cpp) on a pool of
    io_threads threads, one file a task; each ctypes call releases the
    interpreter lock, so the pool runs like the reference's OpenMP loop.
    The bank's bytes equal the device path's."""
    if not native.available():
        raise ImportError("backend='native' needs the native fastx library: "
                          + native.info()["error"])
    p_aux = aux_param if aux_kind == "hll" else 0
    m = aux_param if aux_kind == "smh" else 0

    def one(f):
        regs, regs_aux, smh, n_kmers = native.build_sketches(
            f, k=k, p=PRIMARY_P, p_aux=p_aux, m=m)
        return regs, (regs_aux if aux_kind == "hll" else smh), n_kmers

    with ThreadPoolExecutor(max_workers=io_threads) as pool:
        results = list(pool.map(one, files))
    st["kmers"] = sum(n for _, _, n in results)
    return SketchBank(
        names=list(files), regs=np.stack([r for r, _, _ in results]),
        aux_kind=aux_kind, aux_param=aux_param,
        aux=(np.stack([a for _, a, _ in results])
             if aux_kind is not None else None))


def build_bank_from_files(files, criterion=None, aux_bytes=256, k=DEFAULT_K,
                          io_threads=8, backend="auto", device=None,
                          stats=None):
    """Build a SketchBank from FASTA/FASTQ files (parity: build_sketch).

    backend:
      "device" (and "auto") - host FASTA decode on io_threads threads
        (utils/fasta.fasta_codes: the native reader, which releases the
        interpreter lock) while the device builds the sketches: genomes up
        to the pack budget go PACK_GENOMES to a device pass, at most two
        passes in flight before the oldest is fetched; larger genomes
        stream through sketch_codes_device. Where the native reader does
        not build, the pure-Python reader decodes on one thread: it holds
        the interpreter lock for each line, and a pool of 8 built a
        0.31 Gbp corpus 4.4x slower than one thread on the H100 machine's
        host (PERF.md).
      "native" - the C++ single-pass host builder on io_threads threads;
        raises ImportError where the native library does not build.
    "auto" is the device pipeline, unlike the JAX package, whose "auto"
    sends corpora under 32 MiB to the host builder to spare a remote
    TPU's per-dispatch latency. The bank's bytes are the same on every
    backend and equal the JAX package's.

    device: torch device of the device pipeline; None means CUDA.
    stats: optional dict, filled with backend ("device" or "native"),
    decoder ("native" or "python"), io_threads (the decode or build
    threads used), genomes, and for the native backend kmers (k-mers
    consumed); for the device pipeline the stage seconds
      decode_secs   main-thread wait for decoded files (host decode the
                    device work did not hide)
      decode_busy_secs  per-file decode walls summed (the decode threads)
      pack_secs     pack assembly, upload, launches and the fetch of
                    finished packs (includes their device time)
      chunked_secs  the per-genome chunked path, device time included
      fetch_secs    stacking the fetched rows into the bank arrays
      smh_fallbacks packs that took the full SuperMinHash pass
    and counts: codes (decoded stream length: bases plus one reset per
    record), packs, chunked_genomes.
    """
    if backend not in ("auto", "device", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    aux_kind, aux_param = aux_spec(criterion, aux_bytes)
    st = {} if stats is None else stats
    if backend == "native":
        st.update(backend="native", decoder="native",
                  io_threads=io_threads, genomes=len(files))
        return _build_bank_native(files, aux_kind, aux_param, k, io_threads,
                                  st)
    dev = resolve(device)
    torch.empty(0, device=dev)  # a missing card raises here, not mid-build
    pack_codes = PACK_CODES
    if aux_kind == "smh":
        pack_codes = min(PACK_CODES, SMH_CANDIDATES // aux_param)

    decoder = fasta.decoder()
    threads = io_threads if decoder == "native" else 1
    st.update(backend="device", decoder=decoder, io_threads=threads,
              decode_secs=0.0, decode_busy_secs=0.0, pack_secs=0.0,
              chunked_secs=0.0, fetch_secs=0.0, smh_fallbacks=0,
              genomes=len(files), codes=0, packs=0, chunked_genomes=0)
    regs_list = [None] * len(files)
    aux_list = [None] * len(files)
    as_np = ((lambda t: t.cpu().numpy().view(np.uint64))
             if aux_kind == "smh" else (lambda t: t.cpu().numpy()))
    inflight = deque()
    pack, pack_size = [], 0

    def retire(drain=False):
        """Fetch finished packs, one device-to-host copy per array, keeping
        two packs in flight so the device queue never drains while the
        host assembles the next pack."""
        while inflight and (drain or len(inflight) > 2):
            pk, d_codes, d_off, regs, aux, complete = inflight.popleft()
            if complete is not None and not bool(complete):
                st["smh_fallbacks"] += 1
                aux = _pack_smh_full(d_codes, d_off, k, aux_param)
            regs_np = regs.cpu().numpy()
            aux_np = as_np(aux) if aux is not None else None
            for slot, (i, _) in enumerate(pk):
                regs_list[i] = regs_np[slot]
                if aux_np is not None:
                    aux_list[i] = aux_np[slot]

    def flush():
        nonlocal pack, pack_size
        if not pack:
            return
        t0 = time.perf_counter()
        inflight.append((pack,) + _launch_pack(pack, k, PRIMARY_P, aux_kind,
                                               aux_param, dev))
        retire()
        st["pack_secs"] += time.perf_counter() - t0
        st["packs"] += 1
        pack, pack_size = [], 0

    t_wait = time.perf_counter()
    for i, (codes, busy) in enumerate(_decoded(files, threads)):
        st["decode_secs"] += time.perf_counter() - t_wait
        st["decode_busy_secs"] += busy
        st["codes"] += int(codes.size)
        if codes.size > pack_codes:
            t0 = time.perf_counter()
            regs, aux = sketch_codes_device(codes, k, PRIMARY_P, aux_kind,
                                            aux_param, dev)
            regs_list[i] = regs.cpu().numpy()
            aux_list[i] = as_np(aux) if aux is not None else None
            st["chunked_secs"] += time.perf_counter() - t0
            st["chunked_genomes"] += 1
        else:
            if (pack_size + codes.size > pack_codes
                    or len(pack) == PACK_GENOMES):
                flush()
            pack.append((i, codes))
            pack_size += codes.size
        t_wait = time.perf_counter()
    flush()
    t0 = time.perf_counter()
    retire(drain=True)
    st["pack_secs"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    regs = np.stack(regs_list)
    aux = np.stack(aux_list) if aux_kind is not None else None
    st["fetch_secs"] = time.perf_counter() - t0
    return SketchBank(names=list(files), regs=regs, aux_kind=aux_kind,
                      aux=aux, aux_param=aux_param)
