"""Build and load the port's CUDA kernels at first use.

`nvcc` compiles csrc/screen_fused.cu for sm_90a into a shared library with
a plain C interface under cuda_selection_criteria_tpu_torch/build/ (listed
in .gitignore), which ctypes loads. The library name carries a hash of the
source, so an edited kernel is rebuilt and a stale one is never loaded.
Compiles only from the sources in this package; nothing is downloaded.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "screen_fused.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [
    _P, ctypes.c_longlong, _I, _P,   # regs, n_rows, R, thr
    _P, _I, _F, _I, _F, _F,          # weights, nbins, tail, want_z, 2m, 2m^2
    _P, _P, _P, _I, _I,              # planes, row/col tiles, n_tiles, ti
    _P, _F, _P, _I, _I, _F,          # e, one_tau, fp, n_bands, n_real, tau_cb
    _I, _I, _P, _P, _P,              # use_cb, use_smh, hits, counts, stream
]

_loaded = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build():
    """Compile the kernel library if this source version is not built yet.

    Returns (library path, build seconds, compiler log); seconds is 0.0
    and the log empty when the library already existed."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libscreen_fused_{digest}.so")
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, secs, log


def library():
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = _loaded.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.csc_screen_fused.argtypes = _ARGTYPES
        lib.csc_screen_fused.restype = ctypes.c_int
        _loaded[path] = lib
    return lib
