"""Readers/writers for the reference's on-disk sketch formats, byte-exact
with cuda_selection_criteria_tpu/utils/formats.py:

  * .hll / .hll_{p}: gzip stream of
      uint32[4]{is_calculated, estim, jestim, 1} + uint32 np + double value
      + uint8 core[2^np]
    (reference: sketch/include/sketch/hll.h:1103-1111 write, :1126-1143 read)

  * .smh{m}: gzip stream of uint32 size + size x uint64 raw h_ buckets
    (reference: src/build_sketch.cpp:9-20 write, src/selection.cpp:12-33 read)

  * .npz: a whole stacked sketch bank (save_bank / load_bank).
"""

import gzip
import struct
import zlib

import numpy as np

# EstimationMethod enum values, the .hll header's estim / jestim codes
# (reference: hll.h:61-83).
ESTIM_ORIGINAL = 0
ESTIM_ERTL_IMPROVED = 1
ESTIM_ERTL_MLE = 2
ESTIM_ERTL_JOINT_MLE = 3


def _gz_write(path, payload):
    """Write `payload` gzip-compressed with the reference's exact bytes:
    zlib's gzFile defaults - level 6, a bare 10-byte header with MTIME=0
    and OS=3 - which zlib.compressobj with wbits=31 reproduces (Python's
    gzip module would add FNAME and the current MTIME at level 9)."""
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    data = co.compress(payload) + co.flush()
    with open(path, "wb") as fh:
        fh.write(data)


def read_hll(path):
    """Read a .hll file -> (p, registers uint8 (2^p,), header dict)."""
    with gzip.open(path, "rb") as fh:
        data = fh.read()
    bf = struct.unpack("<4I", data[:16])
    p = struct.unpack("<I", data[16:20])[0]
    value = struct.unpack("<d", data[20:28])[0]
    core = np.frombuffer(data[28 : 28 + (1 << p)], dtype=np.uint8).copy()
    if core.size != (1 << p):
        raise ValueError(f"{path}: truncated register array")
    header = {
        "is_calculated": bf[0],
        "estim": bf[1],
        "jestim": bf[2],
        "magic": bf[3],
        "value": value,
    }
    return p, core, header


def write_hll(path, p, core, value=-1.0, estim=ESTIM_ERTL_MLE,
              jestim=ESTIM_ERTL_MLE, is_calculated=False):
    """Write a .hll file byte-compatible with hll_t::write (hll.h:1103-1111)."""
    core = np.ascontiguousarray(core, dtype=np.uint8)
    if core.size != (1 << p):
        raise ValueError("register count does not match precision")
    payload = (
        struct.pack("<4I", int(bool(is_calculated)), estim, jestim, 1)
        + struct.pack("<I", p)
        + struct.pack("<d", value)
        + core.tobytes()
    )
    _gz_write(path, payload)


def read_smh(path):
    """Read a .smh{m} file -> uint64 (m,) h_ bucket vector."""
    with gzip.open(path, "rb") as fh:
        data = fh.read()
    size = struct.unpack("<I", data[:4])[0]
    h = np.frombuffer(data[4 : 4 + 8 * size], dtype=np.uint64).copy()
    if h.size != size:
        raise ValueError(f"{path}: truncated bucket array")
    return h


def write_smh(path, h):
    """Write a .smh{m} file byte-compatible with write_smh
    (src/build_sketch.cpp:9-20)."""
    h = np.ascontiguousarray(h, dtype=np.uint64)
    payload = struct.pack("<I", h.size) + h.tobytes()
    _gz_write(path, payload)


def save_bank(path, names, regs, cards=None, aux=None, aux_kind=None):
    """Save a stacked sketch bank as .npz (the JAX package's bulk format,
    cuda_selection_criteria_tpu/utils/formats.py:save_bank, without its
    meta_* entries, which no caller writes)."""
    arrays = {
        "names": np.asarray(names, dtype=object).astype(str),
        "regs": np.asarray(regs, dtype=np.uint8),
    }
    if cards is not None:
        arrays["cards"] = np.asarray(cards, dtype=np.float64)
    if aux is not None:
        arrays["aux"] = np.asarray(aux)
        arrays["aux_kind"] = np.asarray(aux_kind or "")
    np.savez_compressed(path, **arrays)


def load_bank(path):
    """Load a .npz sketch bank -> dict of arrays."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
