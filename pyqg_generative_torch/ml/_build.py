"""Build a CUDA source of `csrc/` with `nvcc` into a shared library at first
use, and load it with `ctypes`.

The library gets a plain C interface (no PyTorch headers), so a build takes
seconds. It lands in the package's git-ignored `build/` directory, named by a
hash of the source and the flags; `nvcc -Xptxas -v`'s report of registers,
shared memory and spills is kept beside it as `<library>.log`. Nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "library_path", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu`, compiled on the first
    call of the process if the build directory does not hold it yet."""
    if name in _LOADED:
        return _LOADED[name]
    lib_path = library_path(name)
    if not lib_path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{res.stderr}")
        lib_path.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = lib
    return lib
