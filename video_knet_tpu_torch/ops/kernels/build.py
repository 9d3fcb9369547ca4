"""Build and load the hand-written CUDA kernels.

`csrc/*.cu` is compiled with nvcc for sm_90a into a shared library with a
plain C interface, bound through ctypes (seconds to build; no PyTorch headers):
one nvcc per source, all started together, then one link.
The build runs at first use, from the sources in this checkout, into
`build/` beside this file (git-ignored). The library name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", f) for f in ("mask_ops.cu", "hungarian.cu"))
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvk_kernels_{h.hexdigest()[:16]}.so")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vk_mask_pool.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, p]
    lib.vk_mask_pool.restype = i
    lib.vk_assemble.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.vk_assemble.restype = i
    lib.vk_hungarian.argtypes = [p, p, i, i, i, p]
    lib.vk_hungarian.restype = i
    lib.vk_mask_pool_max_blocks.argtypes = []
    lib.vk_mask_pool_max_blocks.restype = i
    for name in ("vk_mask_pool_block_cols", "vk_mask_pool_block_rows",
                 "vk_mask_pool_block_hw"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    return lib


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, src],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for src, o in zip(SOURCES, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            codes = [proc.returncode for proc in procs]
            if not any(codes):
                link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
                codes.append(link.returncode)
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
            build_seconds = time.perf_counter() - t0
            build_log = "".join(logs)
            if any(codes):
                raise RuntimeError(f"nvcc failed ({codes}):\n{build_log}")
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        _lib = _declare(ctypes.CDLL(path))
        return _lib
