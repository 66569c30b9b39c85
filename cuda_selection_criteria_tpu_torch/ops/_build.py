"""Build and load the port's CUDA kernels and its host library at first
use.

Each kernel source csrc/<name>.cu is compiled by `nvcc` for sm_90a into a
shared library of its own with a plain C interface, under
cuda_selection_criteria_tpu_torch/build/ (listed in .gitignore), which
ctypes loads. A library's name carries a hash of its source and of the
shared headers (csrc/*.cuh), so an edited kernel is rebuilt and a stale one
is never loaded. build() starts one nvcc per missing library, all at once.
build_host() compiles the host C++ library (native/fastx.cpp) with g++ into
the same directory, named by a hash of its source, flags and host CPU.
Compiles only from the sources in this package; nothing is downloaded.
"""

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX = "g++"
GXX_FLAGS = ["-O3", "-std=c++17", "-march=native", "-fPIC", "-Wall",
             "-shared"]
GXX_LIBS = ["-lz", "-lpthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# kernel name (csrc/<name>.cu) -> (C entry point, its ctypes argtypes)
KERNELS = {
    "screen_fused": ("csc_screen_fused", [
        _P, _LL, _P, _LL, _I,    # regs, n_rows, regs_cols, n_cols, R
        _P, _P, _I, _F, _I,      # thr, weights, nbins, tail, want_z
        _F, _F, _P, _P, _I,      # 2m, 2m^2, planes, planes_cols, Wp
        _P, _P, _I, _I,          # row/col tiles, n_tiles, ti
        _P, _P, _F, _P, _P, _I,  # e, e_cols, one_tau, fp, fp_cols, n_bands
        _LL, _LL, _LL, _F,       # n_real, row_base, col_base, tau_cb
        _I, _I, _P, _P, _P,      # use_cb, use_smh, hits, counts, stream
    ]),
    "weighted_cdf_sum": ("csc_weighted_cdf_sum", [
        _P, _LL, _P, _LL, _I,    # regs, n_rows, regs_cols, n_cols, R
        _P, _P, _I, _F, _I,      # thr, weights, nbins, tail, emit_z0
        _P, _P, _I, _P, _P,      # planes, planes_cols, row_words, tiles
        _I, _I, _I, _P, _P, _P,  # n_tiles, ti, tj, s, z, stream
    ]),
    "gate_counts": ("csc_gate_counts", [
        _P, _P, _P, _P, _I,      # e_rows, e_cols, fp_rows, fp_cols, n_bands
        _LL, _LL, _P, _P, _I,    # n_rows, n_cols, row/col tiles, n_tiles
        _I, _LL, _LL, _LL, _F,   # ti, n_real, row_base, col_base, tau_cb
        _I, _I, _P, _P,          # use_cb, use_smh, counts, stream
    ]),
}

_loaded = {}


def source(name):
    return os.path.join(CSRC, f"{name}.cu")


def _target(name):
    h = hashlib.sha1()
    for path in [source(name)] + sorted(glob.glob(os.path.join(CSRC,
                                                               "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build(names=None):
    """Compile every named kernel library (default: all of KERNELS) that
    is not built yet, one nvcc process per source, all started together.

    Returns {name: (library path, build seconds, compiler log)}; seconds
    is 0.0 and the log empty for a library that already existed."""
    out, todo = {}, {}
    for name in KERNELS if names is None else names:
        path = _target(name)
        if os.path.exists(path):
            out[name] = (path, 0.0, "")
        else:
            todo[name] = path
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", f"{path}.tmp{os.getpid()}", source(name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in todo.items()}
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    secs = time.perf_counter() - t0
    failed = [name for name, proc in procs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[name] for name in failed))
    for name, path in todo.items():
        os.replace(f"{path}.tmp{os.getpid()}", path)
        out[name] = (path, secs, logs[name])
    return out


def library(name):
    """The loaded library of kernel `name`: built if needed and loaded at
    the first call in this process, which then keeps it (the sources are
    hashed once, not at every launch)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name][0])
        entry, argtypes = KERNELS[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def _host_cpu():
    """The host CPU's model and feature flags: code built with
    -march=native on one CPU may not run on another, and a checkout (its
    build directory included) can be copied to another machine."""
    try:
        with open("/proc/cpuinfo") as fh:
            return "".join(line for line in fh
                           if line.startswith(("model name", "flags")))
    except OSError:
        return platform.machine()


def build_host(source, name):
    """Compile the C++ source with g++ into BUILD_DIR/lib{name}_{hash}.so,
    unless a library of the same source, flags and host CPU exists.

    Written under a temporary name and renamed into place, so processes
    that build the same library at once never load a partial file.
    Returns (library path, build seconds, compiler log); seconds is 0.0
    and the log empty for a library that already existed. Raises
    RuntimeError when g++ is missing or fails (no zlib.h, for one)."""
    h = hashlib.sha1()
    with open(source, "rb") as fh:
        h.update(fh.read())
    h.update(repr((GXX_FLAGS, GXX_LIBS)).encode())
    h.update(_host_cpu().encode())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    gxx = shutil.which(GXX)
    if gxx is None:
        raise RuntimeError(f"{GXX} not found: the host library {name} "
                           "builds only where a C++ compiler is installed")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [gxx, *GXX_FLAGS, source, "-o", tmp, *GXX_LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{log}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0, log
