"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, into ``_build/`` inside the package.
The library's file name carries a hash of every file under ``csrc/``
(sources and headers) and of the flags, so an edited source or header never
loads a stale build. Every C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; ``launch`` raises when that is not 0.
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

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DIGESTED = (".cu", ".cuh", ".h")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers, ints, floats; the last two are
# the device index and the stream)
SIGNATURES = {
    "pacoh_svgd_phi": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    "pacoh_svgd_phi_usage": (_I, _P, _I, _P),
    "pacoh_mll_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pacoh_mll_fwd_usage": (_I, _P, _I, _P),
    "pacoh_mll_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pacoh_mll_bwd_usage": (_I, _P, _I, _P),
    "pacoh_chol": (_P, _P, _I, _I, _I, _P),
    "pacoh_chol_blocks_per_sm": (_I, _P, _I, _P),
    "pacoh_chol_small": (_P, _P, _I, _I, _I, _P),
    "pacoh_chol_small_usage": (_I, _P, _I, _P),
    "pacoh_blocked_mll_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pacoh_blocked_mll_fwd_blocks_per_sm": (_I, _P, _I, _P),
    "pacoh_blocked_mll_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pacoh_blocked_mll_bwd_blocks_per_sm": (_I, _P, _I, _P),
    "pacoh_fused_svgd": (_P,) * 13 + (_I,) * 12 + (_F,) * 3 + (_I, _P),
    "pacoh_fused_svgd_clusters": (_I,) * 11 + (_P, _I, _P),
    "pacoh_fused_map": (_P,) * 12 + (_I,) * 12 + (_F,) * 4 + (_I, _P),
    "pacoh_fused_map_cluster": (_P,) * 11 + (_I,) * 12 + (_F,) * 4 + (_I, _P),
    "pacoh_fused_map_bign": (_P,) * 16 + (_I,) * 15 + (_F,) * 4 + (_I, _P),
    "pacoh_fused_vi": (_P,) * 18 + (_I,) * 11 + (_F,) * 6 + (_I, _P),
    "pacoh_fused_vi_clusters": (_I,) * 9 + (_P, _I, _P),
    "pacoh_fused_mlap": (_P,) * 28 + (_I,) * 12 + (_F,) * 10 + (_I, _P),
    "pacoh_fused_mlap_clusters": (_I,) * 9 + (_P, _I, _P),
    "pacoh_fused_mlap_tiled": (_P,) * 28 + (_I,) * 12 + (_F,) * 10 + (_I, _P),
    "pacoh_fused_mlap_tiled_clusters": (_I,) * 9 + (_P, _I, _P),
    "pacoh_fused_svgd_bign": (_P,) * 17 + (_I,) * 12 + (_F,) * 3 + (_I, _P),
    "pacoh_fused_vi_bign": (_P,) * 21 + (_I,) * 11 + (_F,) * 6 + (_I, _P),
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


def _csrc_files(suffixes):
    names = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(suffixes))
    return [os.path.join(CSRC_DIR, f) for f in names]


def _run(procs):
    """Wait for every (cmd, Popen); raise on the first failure, after all ended."""
    logs, failed = [], None
    for cmd, proc in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _compile(sources, target):
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tag = f"{target}.{os.getpid()}"
    objects = [f"{tag}.{os.path.basename(src)}.o" for src in sources]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    try:
        procs = []
        for src, obj in zip(sources, objects):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        log = _run(procs)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", f"{tag}.tmp", *objects]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))])
        os.replace(f"{tag}.tmp", target)
    finally:
        for path in objects:
            if os.path.exists(path):
                os.remove(path)
    build_info.update(seconds=time.perf_counter() - t0, log=log)


def library():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _csrc_files(".cu")
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in _csrc_files(_DIGESTED):
            digest.update(os.path.basename(path).encode())
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


def kernel_usage(entry, instance, device="cuda"):
    """(registers, local-memory bytes a thread) of a kernel instance by
    cudaFuncGetAttributes, through C entry point ``entry`` (``instance``
    picks the template instance; see the source). Local memory holds a
    kernel's spills and stack frame, so 0 means neither, whichever build
    loaded the library."""
    import torch

    out = (ctypes.c_int * 2)()
    launch(entry, torch.empty(0, device=device), instance, ctypes.addressof(out))
    return out[0], out[1]
