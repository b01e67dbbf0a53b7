"""Build and ctypes bindings of the native sample loader.

Twin of `pyqg_generative_tpu/utils/native.py`. The loader is the port's copy
of the twin's `fastloader.cpp` (`native/fastloader.cpp`), with its slot
collision and its lost wakeup fixed (the copy's header says how): an mmap'ed
float32 sample store whose worker threads assemble the shuffled batches
ahead of the consumer. g++ builds it at first use into the package's
git-ignored `build/`, named by a hash of the source and the flags (the twin
compares modification times). The store's format is the twin's, so each
package reads the other's store.

Where the twin falls back to numpy when the build or `fl_open` fails, the
port raises and says why. The numpy path runs only when the caller asks for
it (`force_python=True`); it is the plain version, in the twin's numpy order
(a permutation from `np.random.default_rng(seed)`), which is not the native
loader's order.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build_native", "library_path", "write_sample_store",
           "FastLoader"]

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "fastloader.cpp"
BUILD = _PKG / "build"
CXX = "g++"
# the twin's flags without -march=native: the loader copies memory, and a
# library built for one host's CPU may be loaded from a shared checkout on
# another
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_build_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join((CXX,) + FLAGS).encode())
    return BUILD / f"libfastloader-{digest.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> str:
    """Compile fastloader.cpp into the build directory unless it holds the
    library already; returns its path, and raises with the compiler's
    output if the build fails."""
    with _build_lock:
        path = library_path()
        if path.exists() and not force:
            return str(path)
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *FLAGS, str(SRC), "-o", str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"the native loader did not build: "
                               f"{' '.join(cmd)}: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"the native loader did not build: "
                               f"{' '.join(cmd)}:\n{r.stderr}")
        os.replace(tmp, path)
        return str(path)


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.fl_open.restype = ctypes.c_long
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    lib.fl_start_epoch.restype = ctypes.c_long
    lib.fl_start_epoch.argtypes = [ctypes.c_long, ctypes.c_ulong,
                                   ctypes.c_long, ctypes.c_int]
    lib.fl_next_batch.restype = ctypes.c_long
    lib.fl_next_batch.argtypes = [ctypes.c_long, ctypes.c_void_p]
    lib.fl_batch_size.restype = ctypes.c_long
    lib.fl_batch_size.argtypes = [ctypes.c_long]
    lib.fl_close.argtypes = [ctypes.c_long]
    _lib = lib
    return lib


# --------------------------------------------------------------- sample store

def write_sample_store(folder: str, arrays: dict[str, np.ndarray]):
    """Persist named sample arrays (same leading dim) as one raw float32
    blob + meta.json. Samples are the concatenation of each array's
    per-sample flattening, in key order."""
    keys = sorted(arrays.keys())
    n = arrays[keys[0]].shape[0]
    parts = []
    meta = {"n_samples": int(n), "fields": {}}
    offset = 0
    for k in keys:
        a = np.ascontiguousarray(arrays[k], dtype=np.float32)
        assert a.shape[0] == n, (k, a.shape)
        flat = a.reshape(n, -1)
        meta["fields"][k] = {"shape": list(a.shape[1:]),
                             "offset": offset, "size": flat.shape[1]}
        offset += flat.shape[1]
        parts.append(flat)
    meta["sample_floats"] = offset
    os.makedirs(folder, exist_ok=True)
    blob = np.concatenate(parts, axis=1)
    blob.tofile(os.path.join(folder, "data.bin"))
    with open(os.path.join(folder, "meta.json"), "w") as f:
        json.dump(meta, f)


_OPEN_ERRORS = {-1: "cannot open", -2: "cannot stat",
                -3: "is shorter than n_samples x sample_floats in",
                -4: "cannot mmap"}


class FastLoader:
    """Shuffled minibatch iterator over a sample store, native unless the
    caller asks for numpy (`force_python`).

    Usage:
        fl = FastLoader(folder, batch_size=64)
        for batch in fl.epoch(seed=0):   # dict of field -> (bs, ...) float32
            ...
    """

    def __init__(self, folder: str, batch_size: int = 64,
                 drop_last: bool = False, force_python: bool = False):
        with open(os.path.join(folder, "meta.json")) as f:
            self.meta = json.load(f)
        self.folder = folder
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.n_samples = self.meta["n_samples"]
        self.sample_floats = self.meta["sample_floats"]
        self._lib = None if force_python else _load_lib()
        self._handle = None
        data_path = os.path.join(folder, "data.bin")
        if self._lib is not None:
            h = self._lib.fl_open(data_path.encode(), self.n_samples,
                                  self.sample_floats)
            if h <= 0:
                raise RuntimeError(f"fl_open: {data_path}: "
                                   f"{_OPEN_ERRORS.get(h, h)} the store")
            self._handle = h
        else:
            self._mm = np.memmap(data_path, dtype=np.float32, mode="r",
                                 shape=(self.n_samples, self.sample_floats))

    @property
    def native(self) -> bool:
        return self._handle is not None

    def n_batches(self) -> int:
        bs = self.batch_size
        return self.n_samples // bs if self.drop_last else \
            -(-self.n_samples // bs)

    def _split(self, flat: np.ndarray) -> dict[str, np.ndarray]:
        """A (bs, sample_floats) block as {field: (bs, *shape)} views."""
        out = {}
        for k, info in self.meta["fields"].items():
            seg = flat[:, info["offset"]:info["offset"] + info["size"]]
            out[k] = seg.reshape((flat.shape[0],) + tuple(info["shape"]))
        return out

    def epoch(self, seed: int = 0, out=None, before_fill=None):
        """The epoch's batches as dicts of field arrays. Without `out`, each
        batch is a fresh copy. With `out`, a list of (batch_size,
        sample_floats) float32 buffers (numpy arrays or CPU tensors, pinned
        ones for a copy to the card), batch b is written into
        out[b % len(out)] and the dict holds views of it; `before_fill(k)`,
        where given, is called before buffer k is written, to wait until its
        last batch has been read."""
        bs = self.batch_size
        bufs = None if out is None else [np.asarray(o) for o in out]
        for buf in bufs or ():
            if buf.shape != (bs, self.sample_floats) or \
                    buf.dtype != np.float32 or not buf.flags.c_contiguous:
                raise ValueError(f"an output buffer must be a contiguous "
                                 f"({bs}, {self.sample_floats}) float32 "
                                 f"array, not {buf.dtype}{buf.shape}")
        if self.native:
            nb = self._lib.fl_start_epoch(self._handle, seed, bs,
                                          1 if self.drop_last else 0)
            own = np.empty((bs, self.sample_floats), dtype=np.float32)
            for b in range(nb):
                buf = own if bufs is None else bufs[b % len(bufs)]
                if bufs is not None and before_fill is not None:
                    before_fill(b % len(bufs))
                idx = self._lib.fl_next_batch(self._handle,
                                              buf.ctypes.data)
                if idx != b:
                    raise RuntimeError(f"fl_next_batch gave batch {idx} "
                                       f"where {b} of {nb} was due")
                yield self._split(own.copy() if bufs is None else buf)
        else:
            rng = np.random.default_rng(seed)
            order = rng.permutation(self.n_samples)
            for b in range(self.n_batches()):
                idx = order[b * bs:(b + 1) * bs]
                if len(idx) < bs:  # wrap like the native path
                    idx = np.concatenate(
                        [idx, order[:bs - len(idx)]])
                if bufs is None:
                    yield self._split(np.asarray(self._mm[idx]))
                    continue
                k = b % len(bufs)
                if before_fill is not None:
                    before_fill(k)
                np.take(self._mm, idx, axis=0, out=bufs[k])
                yield self._split(bufs[k])

    def close(self):
        """Join the producer threads and unmap the store."""
        if self._handle is not None:
            self._lib.fl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
