"""Verbatim copy of `pyqg_generative_tpu/utils/xrlite.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Lightweight labeled N-d arrays: the framework's dataset layer.

The reference stack (m2lines/pyqg_generative) leans on xarray + netcdf for every
experiment artifact (snapshots, training data, metrics; e.g. reference
`tools/simulate.py:39-60`, `tools/cnn_tools.py:51-52`). This TPU build keeps all
*compute* in jax arrays; `xrlite` is the thin host-side container used only at
experiment boundaries (save/load, metric tables). Persistence is a single
`.npz` archive per dataset (dims/coords/attrs serialized alongside the data),
which is dependency-free and fast.

Only the surface actually used by this framework is implemented, on purpose.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Mapping

import numpy as np

__all__ = ["DataArray", "Dataset", "concat"]


def _as_tuple(x) -> tuple:
    if x is None:
        return ()
    if isinstance(x, str):
        return (x,)
    return tuple(x)


class DataArray:
    """A numpy array with named dimensions, per-dimension coordinates and attrs."""

    __slots__ = ("data", "dims", "coords", "attrs")

    def __init__(self, data, dims=None, coords=None, attrs=None):
        self.data = np.asarray(data)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self.data.ndim))
        self.dims = _as_tuple(dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(
                f"dims {self.dims} incompatible with shape {self.data.shape}")
        self.coords = {}
        if coords:
            for name, arr in coords.items():
                if name in self.dims:
                    self.coords[name] = np.asarray(arr)
        self.attrs = dict(attrs or {})

    # ---------------------------------------------------------------- basics
    @property
    def values(self) -> np.ndarray:
        return self.data

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def sizes(self):
        return dict(zip(self.dims, self.data.shape))

    def copy(self, deep: bool = True) -> "DataArray":
        return DataArray(self.data.copy() if deep else self.data, self.dims,
                         dict(self.coords), dict(self.attrs))

    def astype(self, dtype) -> "DataArray":
        return DataArray(self.data.astype(dtype), self.dims, self.coords,
                         self.attrs)

    def rename(self, mapping: Mapping[str, str]) -> "DataArray":
        dims = tuple(mapping.get(d, d) for d in self.dims)
        coords = {mapping.get(k, k): v for k, v in self.coords.items()}
        return DataArray(self.data, dims, coords, self.attrs)

    def __repr__(self):
        dims = ", ".join(f"{d}: {s}" for d, s in zip(self.dims, self.shape))
        return f"<xrlite.DataArray ({dims}) dtype={self.dtype}>"

    # ------------------------------------------------------------- selection
    def isel(self, indexers: Mapping[str, object] | None = None, **kw) -> "DataArray":
        idx = dict(indexers or {})
        idx.update(kw)
        slicer = []
        new_dims = []
        for d in self.dims:
            if d in idx:
                sel = idx[d]
                slicer.append(sel)
                if isinstance(sel, slice) or (np.ndim(sel) > 0):
                    new_dims.append(d)
            else:
                slicer.append(slice(None))
                new_dims.append(d)
        # apply sequentially to support fancy per-axis indexing independently
        out = self.data
        axis = 0
        coords = {}
        for d, sel in zip(self.dims, slicer):
            if isinstance(sel, slice) or np.ndim(sel) > 0 or sel is Ellipsis:
                out = out[(slice(None),) * axis + (sel,)]
                if d in self.coords:
                    coords[d] = self.coords[d][sel]
                axis += 1
            else:
                out = out[(slice(None),) * axis + (sel,)]
        for d in new_dims:
            if d in self.coords and d not in coords:
                coords[d] = self.coords[d]
        return DataArray(out, tuple(new_dims), coords, self.attrs)

    def sel(self, indexers: Mapping[str, object] | None = None,
            method: str | None = None, **kw) -> "DataArray":
        """Coordinate-value based selection (xarray .sel subset).

        Scalars and slices are supported. Exact match by default;
        method='nearest' picks the closest coordinate value. Slices select
        the inclusive coordinate range (like xarray label slicing)."""
        idx = dict(indexers or {})
        idx.update(kw)
        iidx = {}
        for d, sel in idx.items():
            if d not in self.coords:
                raise KeyError(f"no coordinate for dim {d!r}")
            c = self.coords[d]
            if isinstance(sel, slice):
                lo = -np.inf if sel.start is None else sel.start
                hi = np.inf if sel.stop is None else sel.stop
                iidx[d] = np.nonzero((c >= lo) & (c <= hi))[0]
            else:
                pos = int(np.argmin(np.abs(c - sel)))
                if method != "nearest" and not np.isclose(c[pos], sel):
                    raise KeyError(
                        f"value {sel!r} not found in coordinate {d!r} "
                        f"(pass method='nearest')")
                iidx[d] = pos
        return self.isel(iidx)

    def expand_dims(self, dim: str, axis: int = 0) -> "DataArray":
        if dim in self.dims:
            return self
        data = np.expand_dims(self.data, axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return DataArray(data, tuple(dims), self.coords, self.attrs)

    def transpose(self, *dims: str) -> "DataArray":
        order = [self.dims.index(d) for d in dims]
        return DataArray(self.data.transpose(order), dims, self.coords,
                         self.attrs)

    def stack_dims(self, new_dim: str, dims: Iterable[str]) -> "DataArray":
        """Collapse `dims` (must be leading, in order) into one axis."""
        dims = tuple(dims)
        assert self.dims[:len(dims)] == dims, (self.dims, dims)
        rest = self.data.shape[len(dims):]
        data = self.data.reshape((-1,) + rest)
        return DataArray(data, (new_dim,) + self.dims[len(dims):],
                         {d: v for d, v in self.coords.items() if d not in dims},
                         self.attrs)

    # ------------------------------------------------------------ reductions
    def _axes(self, dim) -> tuple:
        if dim is None:
            return tuple(range(self.ndim))
        dims = _as_tuple(dim)
        return tuple(self.dims.index(d) for d in dims)

    def _reduce(self, fn, dim=None, **kw) -> "DataArray":
        axes = self._axes(dim)
        data = fn(self.data, axis=axes, **kw)
        keep = tuple(d for i, d in enumerate(self.dims) if i not in axes)
        coords = {d: v for d, v in self.coords.items() if d in keep}
        return DataArray(data, keep, coords, self.attrs)

    def mean(self, dim=None, **kw):
        return self._reduce(np.mean, dim, **kw)

    def std(self, dim=None, **kw):
        return self._reduce(np.std, dim, **kw)

    def var(self, dim=None, **kw):
        return self._reduce(np.var, dim, **kw)

    def sum(self, dim=None, **kw):
        return self._reduce(np.sum, dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce(np.min, dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce(np.max, dim, **kw)

    # ------------------------------------------------------------ arithmetic
    def _binary(self, other, fn) -> "DataArray":
        if isinstance(other, DataArray):
            a, b = _align(self, other)
            out = fn(a.data, b.data)
            coords = {**b.coords, **a.coords}
            return DataArray(out, a.dims, coords, self.attrs)
        return DataArray(fn(self.data, other), self.dims, self.coords,
                         self.attrs)

    def __add__(self, o):
        return self._binary(o, np.add)

    def __radd__(self, o):
        return self._binary(o, lambda a, b: np.add(b, a))

    def __sub__(self, o):
        return self._binary(o, np.subtract)

    def __rsub__(self, o):
        return self._binary(o, lambda a, b: np.subtract(b, a))

    def __mul__(self, o):
        return self._binary(o, np.multiply)

    def __rmul__(self, o):
        return self._binary(o, lambda a, b: np.multiply(b, a))

    def __truediv__(self, o):
        return self._binary(o, np.divide)

    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: np.divide(b, a))

    def __pow__(self, o):
        return self._binary(o, np.power)

    def __neg__(self):
        return DataArray(-self.data, self.dims, self.coords, self.attrs)

    def __float__(self):
        return float(self.data)


def _align(a: DataArray, b: DataArray) -> tuple[DataArray, DataArray]:
    """Broadcast two DataArrays by dimension names (subset alignment only)."""
    if a.dims == b.dims:
        return a, b
    # the array with fewer dims is broadcast against the other
    big, small, flipped = (a, b, False) if a.ndim >= b.ndim else (b, a, True)
    missing = [d for d in small.dims if d not in big.dims]
    if missing:
        raise ValueError(f"cannot align dims {a.dims} with {b.dims}")
    # move small's dims into big's order, inserting new axes
    shape = []
    src = []
    for d in big.dims:
        if d in small.dims:
            src.append(small.dims.index(d))
    reordered = np.transpose(small.data, src) if src else small.data
    it = iter(range(reordered.ndim))
    for d in big.dims:
        if d in small.dims:
            shape.append(reordered.shape[next(it)])
        else:
            shape.append(1)
    small_b = DataArray(reordered.reshape(shape), big.dims, small.coords)
    return (big, small_b) if not flipped else (small_b, big)


class Dataset:
    """An ordered mapping of named DataArrays plus global attrs."""

    def __init__(self, data_vars: Mapping[str, DataArray] | None = None,
                 attrs: Mapping | None = None):
        self._vars: dict[str, DataArray] = {}
        self.attrs = dict(attrs or {})
        for k, v in (data_vars or {}).items():
            self[k] = v

    # ----------------------------------------------------------- dict-like
    def __getitem__(self, key: str) -> DataArray:
        return self._vars[key]

    def __setitem__(self, key: str, value):
        if not isinstance(value, DataArray):
            value = DataArray(np.asarray(value))
        self._vars[key] = value

    def __contains__(self, key):
        return key in self._vars

    def __delitem__(self, key):
        del self._vars[key]

    def __getattr__(self, key):
        vars_ = object.__getattribute__(self, "_vars")
        if key in vars_:
            return vars_[key]
        raise AttributeError(key)

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    @property
    def data_vars(self):
        return self._vars

    def update(self, other):
        if isinstance(other, Dataset):
            other = other._vars
        for k, v in other.items():
            self[k] = v
        return self

    def copy(self, deep=True):
        return Dataset({k: v.copy(deep) for k, v in self._vars.items()},
                       self.attrs)

    def drop_vars(self, names):
        names = set(_as_tuple(names))
        return Dataset({k: v for k, v in self._vars.items()
                        if k not in names}, self.attrs)

    def rename(self, mapping):
        return Dataset({mapping.get(k, k): v for k, v in self._vars.items()},
                       self.attrs)

    def astype(self, dtype):
        out = {}
        for k, v in self._vars.items():
            out[k] = v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v
        return Dataset(out, self.attrs)

    def isel(self, indexers=None, **kw) -> "Dataset":
        idx = dict(indexers or {})
        idx.update(kw)
        out = {}
        for k, v in self._vars.items():
            sub = {d: s for d, s in idx.items() if d in v.dims}
            out[k] = v.isel(**sub) if sub else v
        return Dataset(out, self.attrs)

    def sel(self, indexers=None, method: str | None = None,
            **kw) -> "Dataset":
        """Coordinate-value based selection over all variables (see
        DataArray.sel)."""
        idx = dict(indexers or {})
        idx.update(kw)
        out = {}
        for k, v in self._vars.items():
            sub = {d: s for d, s in idx.items() if d in v.dims}
            out[k] = v.sel(sub, method=method) if sub else v
        return Dataset(out, self.attrs)

    def sizes(self):
        out = {}
        for v in self._vars.values():
            out.update(v.sizes())
        return out

    def dim_size(self, dim: str) -> int:
        return self.sizes()[dim]

    def __repr__(self):
        lines = [f"<xrlite.Dataset ({len(self._vars)} vars)>"]
        for k, v in self._vars.items():
            lines.append(f"  {k}: {v!r}")
        return "\n".join(lines)

    # ----------------------------------------------------------- persistence
    def to_npz(self, path: str):
        payload = {}
        meta = {"attrs": _jsonable(self.attrs), "vars": {}, "coords": {}}
        coords_seen = {}
        for k, v in self._vars.items():
            payload[f"var__{k}"] = v.data
            meta["vars"][k] = {"dims": list(v.dims), "attrs": _jsonable(v.attrs)}
            for d, c in v.coords.items():
                coords_seen[d] = c
        for d, c in coords_seen.items():
            payload[f"coord__{d}"] = c
            meta["coords"][d] = True
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # np.savez appends ".npz" to a bare *path* (which silently broke
        # callers doing their own write-to-tmp + os.replace atomicity: the
        # tmp file materialized under a different name and the replace
        # failed). Normalize the suffix, write through a file object (no
        # suffix games), and publish atomically ourselves.
        if not path.endswith(".npz"):
            path += ".npz"
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    # alias mirroring the reference's netcdf emission points
    to_netcdf = to_npz

    @classmethod
    def from_npz(cls, path: str) -> "Dataset":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            coords = {d: z[f"coord__{d}"] for d in meta.get("coords", {})}
            ds = cls(attrs=meta.get("attrs", {}))
            for k, info in meta["vars"].items():
                dims = tuple(info["dims"])
                cd = {d: coords[d] for d in dims if d in coords}
                ds[k] = DataArray(z[f"var__{k}"], dims, cd, info.get("attrs"))
        return ds


def _jsonable(d: Mapping) -> dict:
    out = {}
    for k, v in dict(d).items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


def concat(items: Iterable[Dataset | DataArray], dim: str):
    """Concatenate Datasets or DataArrays along `dim` (created if missing)."""
    items = list(items)
    if isinstance(items[0], DataArray):
        items = [x if dim in x.dims else x.expand_dims(dim) for x in items]
        axis = items[0].dims.index(dim)
        data = np.concatenate([x.data for x in items], axis=axis)
        coords = dict(items[0].coords)
        if all(dim in x.coords for x in items):
            coords[dim] = np.concatenate([x.coords[dim] for x in items])
        else:
            coords.pop(dim, None)
        return DataArray(data, items[0].dims, coords, items[0].attrs)
    # Dataset: vars with `dim` (or present in all with differing stacking) concat,
    # others taken from the last item (mirrors reference concat_in_time which
    # keeps the final running-averaged spectra; reference tools/simulate.py:39-60)
    keys = [k for k in items[0].keys() if all(k in x for x in items)]
    out = Dataset(attrs=items[0].attrs)
    for k in keys:
        vs = [x[k] for x in items]
        out[k] = concat(vs, dim)
    return out


def open_mfdataset(paths: Iterable[str], concat_dim: str = "run") -> Dataset:
    """Open many per-member .npz files and concatenate along `concat_dim`.

    Replaces the reference's `xr.open_mfdataset(..., concat_dim='run')`
    reduction step (reference tools/cnn_tools.py:51-52).
    """
    import glob as _glob
    if isinstance(paths, str):
        # never pick up sidecar statistics caches written next to the runs
        paths = sorted(p for p in _glob.glob(paths)
                       if not p.endswith(".cache_npz.npz"))
    dss = [Dataset.from_npz(p) for p in paths]
    return concat(dss, concat_dim)
