"""Build and load the port's native PNG unfilter (`png_codec.cpp`).

    python -m video_knet_tpu_torch.native.build

g++ alone builds it (`-O3 -shared -fPIC`, no zlib, no other library) at
first use, into `build/` beside this file (git-ignored). The library name
carries a hash of the source and flags, so an edited source is rebuilt and
a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "png_codec.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++) found to build the PNG codec "
                       f"{SOURCE}")


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvk_png_{h.hexdigest()[:16]}.so")


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the codec library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run([_compiler(), *FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"building the PNG codec failed:\n{proc.stderr}")
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(path)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.vk_png_unfilter.argtypes = [p, i64, p, i64, i64, i64]
        lib.vk_png_unfilter.restype = ctypes.c_int
        _lib = lib
        return _lib


if __name__ == "__main__":
    load_library()
    print(library_path())
