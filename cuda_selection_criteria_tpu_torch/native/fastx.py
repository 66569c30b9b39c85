"""ctypes bindings for the port's native fastx library (native/fastx.cpp,
a copy of cuda_selection_criteria_tpu/native/fastx.cpp).

The library is compiled at first use by ops/_build.build_host into
cuda_selection_criteria_tpu_torch/build/ and loaded with ctypes.CDLL, which
releases the interpreter lock for the length of each call: a pool of
Python threads runs the C code in parallel. available() is False when it
cannot be built (no g++ or no zlib); every entry point then raises
ImportError, and info() says why.
"""

import ctypes
import os
import threading

import numpy as np

from ..ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fastx.cpp")
_LOCK = threading.Lock()
# after the first _load(): "lib" (the loaded library, or None when it could
# not be built) and "info" (what info() returns)
_state = {}


def _load():
    with _LOCK:
        if "lib" not in _state:
            try:
                path, secs, log = _build.build_host(SOURCE, "fastx")
                lib = ctypes.CDLL(path)
                _bind(lib)
            except (OSError, RuntimeError, AttributeError) as exc:
                _state.update(lib=None, info=dict(
                    path=None, build_secs=None, log="", zlib=None,
                    error=f"{type(exc).__name__}: {exc}"))
            else:
                _state.update(lib=lib, info=dict(
                    path=path, build_secs=secs, log=log,
                    zlib=lib.fastx_zlib_version().decode(), error=None))
        return _state["lib"]


def _bind(lib):
    lib.fastx_read_codes.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_read_codes.restype = ctypes.c_int
    lib.fastx_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.fastx_free.restype = None
    lib.fastx_build_sketches.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint,
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.fastx_build_sketches.restype = ctypes.c_int64
    lib.fastx_read_hll_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fastx_read_hll_batch.restype = ctypes.c_int
    lib.fastx_read_smh_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.fastx_read_smh_batch.restype = ctypes.c_int
    lib.fastx_pair_union_hist.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_pair_union_hist.restype = ctypes.c_int
    lib.fastx_row_hist.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_row_hist.restype = ctypes.c_int
    lib.fastx_pack_bitplanes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fastx_pack_bitplanes.restype = ctypes.c_int
    lib.fastx_value_presence.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fastx_value_presence.restype = ctypes.c_int
    lib.fastx_gather_pack_bitplanes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fastx_gather_pack_bitplanes.restype = ctypes.c_int
    lib.fastx_zlib_version.argtypes = []
    lib.fastx_zlib_version.restype = ctypes.c_char_p


def available():
    return _load() is not None


def info():
    """The library as this process loaded it: {path, build_secs (0.0 when
    an earlier build was found), log (the g++ command lines and output),
    zlib (runtime version and the header built against), error (why it
    could not be built, else None)}."""
    _load()
    return dict(_state["info"])


def _lib():
    lib = _load()
    if lib is None:
        raise ImportError("libfastx unavailable: " + _state["info"]["error"])
    return lib


def fasta_codes(path):
    """Native FASTA -> uint8 code array (0..3 bases, 4 = reset), with a
    leading reset even for a file without records."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.fastx_read_codes(path.encode(), ctypes.byref(out),
                              ctypes.byref(out_len))
    if rc != 0:
        raise IOError(f"fastx_read_codes({path}) failed: rc={rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    finally:
        lib.fastx_free(out)
    return arr


def build_sketches(path, k=31, p=14, p_aux=0, m=0):
    """Single-pass host build: (regs, regs_aux | None, smh | None, n_kmers)."""
    lib = _lib()
    regs = np.zeros(1 << p, np.uint8)
    regs_aux = np.zeros(1 << p_aux, np.uint8) if p_aux else None
    smh = np.zeros(m, np.uint64) if m else None
    n = lib.fastx_build_sketches(
        path.encode(),
        k,
        p,
        regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        p_aux,
        regs_aux.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if regs_aux is not None
        else None,
        m,
        smh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        if smh is not None
        else None,
    )
    if n < 0:
        raise IOError(f"fastx_build_sketches({path}) failed")
    return regs, regs_aux, smh, int(n)


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def read_hll_batch(paths, p, threads=16):
    """Threaded batch load of .hll files into a packed (N, 2^p) bank.
    Raises IOError for a missing or short file and for one of another p."""
    lib = _lib()
    out = np.empty((len(paths), 1 << p), np.uint8)
    rc = lib.fastx_read_hll_batch(
        _paths_array(paths), len(paths), threads, p,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise IOError(f"fastx_read_hll_batch failed: rc={rc}")
    return out


def pair_union_hist(regs, ii, kk, threads=None):
    """Fused gather+max+histogram over index-paired rows of a uint8
    register bank: (B, 64) int64 exact counts of max(regs[i], regs[k]),
    on `threads` threads (default min(8, cores)). Raises ValueError for a
    register value >= 64 or a row index out of range."""
    lib = _lib()
    regs = np.ascontiguousarray(regs, np.uint8)
    ii = np.ascontiguousarray(ii, np.int64)
    kk = np.ascontiguousarray(kk, np.int64)
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    out = np.empty((len(ii), 64), np.int64)
    rc = lib.fastx_pair_union_hist(
        regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        regs.shape[0],
        regs.shape[1],
        ii.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        kk.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ii),
        threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise ValueError(f"fastx_pair_union_hist failed: rc={rc}")
    return out


def row_hist(regs, threads=None):
    """Register histograms of every row of a uint8 (N, m) bank: (N, 64)
    int64 exact counts, each row read once, rows shared out over `threads`
    threads (default min(8, cores)). Raises ValueError for a bank that is
    not 2-D uint8 and for a register value >= 64."""
    lib = _lib()
    regs = np.asarray(regs)
    if regs.ndim != 2 or regs.dtype != np.uint8:
        raise ValueError(f"row_hist needs a 2-D uint8 bank, got "
                         f"{regs.ndim}-D {regs.dtype}")
    regs = np.ascontiguousarray(regs)
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    out = np.empty((regs.shape[0], 64), np.int64)
    rc = lib.fastx_row_hist(
        regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        regs.shape[0],
        regs.shape[1],
        threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise ValueError(f"fastx_row_hist failed: rc={rc}")
    return out


def read_smh_batch(paths, m, threads=16):
    """Threaded batch load of .smh{m} files into a packed (N, m) array.
    Raises IOError for a missing or short file and for one of another m."""
    lib = _lib()
    out = np.empty((len(paths), m), np.uint64)
    rc = lib.fastx_read_smh_batch(
        _paths_array(paths), len(paths), threads, m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise IOError(f"fastx_read_smh_batch failed: rc={rc}")
    return out


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def pack_bitplanes(rows, lut256, k, out, threads=None):
    """Bit-plane pack of uint8 register rows (ops/regpack layout) in one
    native pass: out (S, k, R//8) uint8, little bit order, rows shared out
    over `threads` threads (default min(8, cores)). rows and out must be
    C-contiguous. Raises ValueError when the pack refuses its arguments
    (R not a multiple of 8, k outside 1..7)."""
    lib = _lib()
    if not (rows.flags.c_contiguous and out.flags.c_contiguous):
        raise ValueError("pack_bitplanes needs C-contiguous rows and out")
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    rc = lib.fastx_pack_bitplanes(
        _u8(rows), rows.shape[0], rows.shape[1],
        _u8(np.ascontiguousarray(lut256, np.uint8)), int(k), threads,
        _u8(out))
    if rc != 0:
        raise ValueError(f"fastx_pack_bitplanes failed: rc={rc}")
    return out


def value_presence(data, threads=None):
    """(256,) bool: which byte values occur in the C-contiguous uint8
    array, in one native linear pass on `threads` threads (default
    min(8, cores)): the host alphabet of a packed upload."""
    lib = _lib()
    flat = data.reshape(-1)
    if not (flat.flags.c_contiguous and flat.dtype == np.uint8):
        raise ValueError("value_presence needs a C-contiguous uint8 array")
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    out = np.zeros(256, np.uint8)
    rc = lib.fastx_value_presence(_u8(flat), flat.size, threads, _u8(out))
    if rc != 0:
        raise ValueError(f"fastx_value_presence failed: rc={rc}")
    return out.astype(bool)


def gather_pack_bitplanes(bank, idx, lut256, k, out, threads=None):
    """Fused gather + pack: out[b] = bit-planes of lut256[bank[idx[b]]] in
    one native pass (no gathered slab), rows shared out over `threads`
    threads (default min(8, cores)). bank and out must be C-contiguous.
    Raises ValueError for a row index out of range."""
    lib = _lib()
    if not (bank.flags.c_contiguous and out.flags.c_contiguous):
        raise ValueError("gather_pack_bitplanes needs a C-contiguous bank "
                         "and out")
    idx = np.ascontiguousarray(idx, np.int64)
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    rc = lib.fastx_gather_pack_bitplanes(
        _u8(bank), bank.shape[0], bank.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        _u8(np.ascontiguousarray(lut256, np.uint8)), int(k), threads,
        _u8(out))
    if rc != 0:
        raise ValueError(f"fastx_gather_pack_bitplanes failed: rc={rc}")
    return out
