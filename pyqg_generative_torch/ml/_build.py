"""Build a CUDA source of `csrc/` with `nvcc` into a shared library at first
use, and load it with `ctypes`.

The library gets a plain C interface (no PyTorch headers), so a build takes
seconds. It lands in the package's git-ignored `build/` directory, named by a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags;
`nvcc -Xptxas -v`'s report of registers, shared memory and spills is kept
beside it as `<library>.log`. `build_libraries` starts one `nvcc` for each
missing library, all together. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_libraries", "load_library", "library_path", "nvcc_path"]

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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(names) -> None:
    """Compile the libraries of `names` that the build directory lacks, one
    `nvcc` each, all started together; raise if any build fails."""
    jobs = []
    for name in names:
        lib_path = library_path(name)
        if lib_path.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, lib_path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    try:
        for name, lib_path, tmp, proc in jobs:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{log}")
                continue
            lib_path.with_suffix(".log").write_text(log)
            os.replace(tmp, lib_path)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu`, compiled on the first
    call of the process if the build directory does not hold it yet."""
    if name not in _LOADED:
        build_libraries([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
