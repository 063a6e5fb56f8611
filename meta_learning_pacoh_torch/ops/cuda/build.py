"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, never at import, into ``_build/`` inside the
package. The library's file name carries a hash of the sources and flags,
so an edited source never loads a stale build. Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers, ints, floats; the last two are
# the device index and the stream)
SIGNATURES = {
    "pacoh_svgd_phi": (_P, _P, _P, _I, _I, _F, _I, _P),
    "pacoh_mll_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pacoh_mll_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pacoh_chol": (_P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_info = {}  # filled by the build: library path, seconds, nvcc's log


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    return [os.path.join(CSRC_DIR, f) for f in names]


def _compile(sources, target):
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)
    build_info.update(seconds=time.perf_counter() - t0, log=proc.stderr)


def library():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sources:
            with open(path, "rb") as f:
                digest.update(f.read())
        target = os.path.join(BUILD_DIR, f"libpacoh_kernels_{digest.hexdigest()[:16]}.so")
        build_info.update(path=target, seconds=0.0, log="")
        if not os.path.exists(target):
            _compile(sources, target)
        lib = ctypes.CDLL(target)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def launch(name, tensor, *args):
    """Call C entry point ``name`` on ``tensor``'s device and current stream."""
    import torch

    dev = tensor.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(library(), name)(*args, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
