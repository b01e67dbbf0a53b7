"""Online similarity metrics between parameterized runs and the
coarse-grained high-resolution reference (reference tools/comparison_tools.py).

Twin of `pyqg_generative_tpu/eval/comparison.py`, in numpy and scipy as the
twin is, but for the coarse-graining of the reference's snapshots, which runs
the port's operator on a torch device (the twin jits it):

* `diagnostic_differences(ds1, ds2, T)`: 10 normalized 1-D Wasserstein
  distances of pointwise distributions (q, u, v, KE, Ens x 2 levels) plus 7
  normalized spectral RMSEs (KEspec x2, total energy flux, APEgenspec,
  KEfrictionspec...) truncated below 2/3 of both Nyquists (reference :116-195);
* `coarsegrain_reference_dataset`: coarsens snapshots with the chosen operator
  and truncates + filter-weights the quadratic spectral fluxes
  (reference :53-114);
* `dataset_statistics` / `dataset_smart_read`: derived statistics (relative
  vorticity, KE, enstrophy, PDFs with the paper's axis limits, isotropized
  spectra of every diagnostic, energy-budget sums, KE(t)) with an npz cache
  sidecar (reference :197-410), whose name, fingerprint and layout are the
  twin's, so that each package reads the other's cache.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..qg import operators as op
from ..qg.grid import make_grid
from ..qg.params import AVERAGE_SLICE_ANDREW
from ..qg.spectral import calc_ispec
from ..utils import xrlite as xr
from .metrics import PDF_histogram

__all__ = ["DISTRIB_KEYS", "SPECTRAL_KEYS", "distrib_score", "spectral_score",
           "diagnostic_differences", "coarsegrain_reference_dataset",
           "dataset_statistics", "dataset_smart_read", "curl", "ave_lev_da"]

DISTRIB_KEYS = [f"distrib_diff_{v}{z}" for v in ("q", "u", "v", "KE", "Ens")
                for z in (1, 2)]

SPECTRAL_KEYS = [
    "spectral_diff_KEspec1", "spectral_diff_KEspec2", "spectral_diff_KEflux",
    "spectral_diff_APEflux", "spectral_diff_APEgenspec",
    "spectral_diff_KEfrictionspec", "spectral_diff_Eflux"]

ALL_SPEC_KEYS = ["APEflux", "APEgenspec", "Dissspec", "ENSDissspec",
                 "ENSflux", "ENSfrictionspec", "ENSgenspec", "ENSparamspec",
                 "Ensspec", "KEflux", "KEfrictionspec", "KEspec", "entspec",
                 "paramspec", "paramspec_APEflux", "paramspec_KEflux"]


def distrib_score(sim: dict) -> float:
    vals = [v for k, v in sim.items() if k in DISTRIB_KEYS]
    return float(np.mean(vals)) if vals else float("nan")


def spectral_score(sim: dict) -> float:
    vals = [v for k, v in sim.items() if k in SPECTRAL_KEYS]
    return float(np.mean(vals)) if vals else float("nan")


# ------------------------------------------------------------ derived fields

def curl(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Relative vorticity dv/dx - du/dy over the last two axes (replaces the
    reference's FeatureExtractor('curl(u,v)') string evaluator)."""
    ny, nx = u.shape[-2], u.shape[-1]
    g = make_grid(nx, ny)
    vh = np.fft.rfftn(v, axes=(-2, -1))
    uh = np.fft.rfftn(u, axes=(-2, -1))
    return np.fft.irfftn(g.ik * vh - g.il * uh, s=(ny, nx), axes=(-2, -1))


def _distribution_field(ds: xr.Dataset, label: str, lev: int,
                        tslice) -> np.ndarray:
    u = ds["u"].isel(time=tslice, lev=lev).values
    v = ds["v"].isel(time=tslice, lev=lev).values
    if label == "q":
        return ds["q"].isel(time=tslice, lev=lev).values.ravel()
    if label == "u":
        return u.ravel()
    if label == "v":
        return v.ravel()
    if label == "KE":
        return (u ** 2 + v ** 2).ravel()
    if label == "Ens":
        return (curl(u, v) ** 2).ravel()
    raise ValueError(label)


def ave_lev_da(arr: xr.DataArray, delta: float) -> xr.DataArray:
    """Depth-weighted average over the `lev` dim (reference operators.py:12-27)."""
    if "lev" not in arr.dims:
        return arr
    ax = arr.dims.index("lev")
    w = np.zeros(arr.shape[ax])
    w[0] = delta / (1 + delta)
    w[1] = 1 / (1 + delta)
    shape = [1] * arr.ndim
    shape[ax] = -1
    data = (arr.values * w.reshape(shape)).sum(axis=ax)
    dims = tuple(d for d in arr.dims if d != "lev")
    return xr.DataArray(data, dims, arr.coords, arr.attrs)


# ------------------------------------------------------------ main metric

def _twothirds_nyquist(nx: int) -> float:
    g = make_grid(nx)
    below = np.argwhere(g.filtr[0] < 1)
    return g.k[0][below[0, 0]]


def _spectral_rmse(spec1: np.ndarray, spec2: np.ndarray):
    n1, n2 = spec1.shape[-2], spec2.shape[-2]
    kr1, isp1 = calc_ispec(make_grid(n1), spec1)
    kr2, isp2 = calc_ispec(make_grid(n2), spec2)
    kmax = min(_twothirds_nyquist(n1), _twothirds_nyquist(n2))
    nk = int((kr1 < kmax).sum())
    diff = np.sqrt(np.mean(
        (isp1[..., :nk].astype("float64") -
         isp2[..., :nk].astype("float64")) ** 2))
    scale = np.sqrt(np.mean(isp2[..., :nk].astype("float64") ** 2))
    return diff, scale


def _mean_over_run(ds: xr.Dataset, key: str) -> xr.DataArray:
    var = ds[key]
    return var.mean("run") if "run" in var.dims else var


def diagnostic_differences(ds1: xr.Dataset, ds2: xr.Dataset, T: int = 128):
    """ds2 is the target (used for normalization). Returns
    (normalized_differences, differences, scales)
    (reference comparison_tools.py:116-195)."""
    # imported here: scipy.stats takes seconds to import, which every
    # process that imports the models (a mesh's ranks among them) would pay
    from scipy.stats import wasserstein_distance
    differences, scales = {}, {}
    ts = slice(-T, None)
    for label in ("q", "u", "v", "KE", "Ens"):
        for z in (0, 1):
            q1 = _distribution_field(ds1, label, z, ts)
            q2 = _distribution_field(ds2, label, z, ts)
            k = f"distrib_diff_{label}{z + 1}"
            differences[k] = float(wasserstein_distance(q1, q2))
            scales[k] = float(np.sqrt(np.mean(q2 ** 2)))

    for z in (0, 1):
        s1 = _mean_over_run(ds1, "KEspec").isel(lev=z).values
        s2 = _mean_over_run(ds2, "KEspec").isel(lev=z).values
        k = f"spectral_diff_KEspec{z + 1}"
        differences[k], scales[k] = _spectral_rmse(s1, s2)

    def total_eflux(ds):
        out = 0.0
        for key in ("KEflux", "APEflux", "paramspec_KEflux",
                    "paramspec_APEflux"):
            if key in ds:
                out = out + _mean_over_run(ds, key).values
        return out

    differences["spectral_diff_Eflux"], scales["spectral_diff_Eflux"] = \
        _spectral_rmse(total_eflux(ds1), total_eflux(ds2))

    if "APEgenspec" in ds1 and "APEgenspec" in ds2:
        d, s = _spectral_rmse(_mean_over_run(ds1, "APEgenspec").values,
                              _mean_over_run(ds2, "APEgenspec").values)
        differences["spectral_diff_APEgenspec"] = d
        scales["spectral_diff_APEgenspec"] = s

    # NOT part of the published spectral score: the reference's
    # diagnostic_differences_Perezhogin computes exactly {KEspec1, KEspec2,
    # Eflux, APEgenspec} (comparison_tools.py:164-189) even though its
    # SPECTRAL_KEYS list names seven keys — APEflux/KEflux/KEfrictionspec
    # are never emitted there, so spectral_score averages four values.
    # Keep the extras under non-scoring names for diagnostics.
    for key in ("APEflux", "KEfrictionspec"):
        if key in ds1 and key in ds2:
            d, s = _spectral_rmse(_mean_over_run(ds1, key).values,
                                  _mean_over_run(ds2, key).values)
            differences[f"extra_diff_{key}"] = d
            scales[f"extra_diff_{key}"] = s

    normalized = {k: differences[k] / scales[k] if scales[k] else np.nan
                  for k in differences}
    return normalized, differences, scales


# ---------------------------------------------------- reference coarsening

def coarsegrain_reference_dataset(ds: xr.Dataset, resolution: int,
                                  operator: str, device=None) -> xr.Dataset:
    """Coarse-grain reference snapshots AND quadratic spectral fluxes:
    spectra are truncated to the coarse wavenumber box and multiplied by the
    squared filter transmission (reference comparison_tools.py:53-114). The
    operator runs on `device` (None means CUDA), in the snapshots'
    precision."""
    operator_fn = op.OPERATORS[operator]
    device = resolve_device(device)
    dsf = xr.Dataset(attrs=dict(ds.attrs))
    for var in ("q", "u", "v", "psi"):
        da = ds[var]
        out = operator_fn(torch.as_tensor(da.values, device=device),
                          resolution).cpu().numpy()
        coords = {"time": da.coords["time"]} if "time" in da.coords else None
        dsf[var] = xr.DataArray(out.astype("float32"), da.dims, coords)

    n = resolution // 2
    gc = make_grid(resolution)
    if operator == "Operator1":
        transm = gc.filtr
    elif operator in ("Operator2", "Operator4"):
        transm = np.exp(-gc.wv2 * (2 * gc.dx) ** 2 / 24)
    else:  # sharp truncation only
        transm = np.ones_like(gc.wv2)

    for var in ("KEspec", "KEflux", "APEflux", "APEgenspec",
                "KEfrictionspec"):
        if var not in ds:
            continue
        da = ds[var]
        v = da.values
        trunc = np.concatenate([v[..., :n, :n + 1], v[..., -n:, :n + 1]],
                               axis=-2)
        dims = da.dims[:-2] + ("l", "k")
        dsf[var] = xr.DataArray(trunc * transm ** 2, dims,
                                {"l": gc.ll, "k": gc.kk})
    return dsf


# ------------------------------------------------------------ statistics

_PDF_LIMITS = {("Ens", 0): (0.0, 1e-10), ("Ens", 1): (0.0, 1.5e-12),
               ("KE", 0): (0.0, 1.5e-2), ("KE", 1): (0.0, 5e-4)}


def dataset_statistics(ds: xr.Dataset, delta: float = 0.25,
                       compute_all: bool = True, **kw_ispec) -> xr.Dataset:
    """Derived statistics of a (multi-run) simulation dataset
    (reference comparison_tools.py:197-271,280-410 merged)."""
    stats = xr.Dataset(attrs=dict(ds.attrs))
    nx = ds["q"].shape[-1]
    g = make_grid(nx)

    u, v = ds["u"].values, ds["v"].values
    KE = 0.5 * (u ** 2 + v ** 2)
    omega = curl(u, v)
    if compute_all:
        stats["omega"] = xr.DataArray(omega.astype("float32"), ds["u"].dims)
        stats["KE"] = xr.DataArray(KE.astype("float32"), ds["u"].dims)
        stats["Ens"] = xr.DataArray((0.5 * omega ** 2).astype("float32"),
                                    ds["u"].dims)
        stats["Vabs"] = xr.DataArray(np.sqrt(2 * KE).astype("float32"),
                                     ds["u"].dims)

    # PDFs over the paper's axis limits
    nt = ds["q"].sizes()["time"]
    tslice = AVERAGE_SLICE_ANDREW if (compute_all and nt > 44) \
        else slice(-1, None)
    variables = ("q", "u", "v", "KE", "Ens") if compute_all \
        else ("q", "u", "v", "KE")
    for var in variables:
        for lev in (0, 1):
            vals = _distribution_field(ds, var, lev, tslice)
            if var == "KE":
                vals = 0.5 * vals
            if var == "Ens":
                vals = 0.5 * vals
            xmin = 0.0 if var in ("KE", "Ens") else None
            xmax = _PDF_LIMITS.get((var, lev), (None, None))[1]
            pts, dens = PDF_histogram(vals, xmin=xmin, xmax=xmax)
            stats[f"PDF_{var}{lev + 1}"] = xr.DataArray(
                dens, (f"{var}_{lev}",), {f"{var}_{lev}": pts})

    # isotropized spectra of every accumulated diagnostic
    for key in ALL_SPEC_KEYS:
        if key not in ds:
            continue
        var = _mean_over_run(ds, key)
        if "lev" in var.dims:
            sps = []
            for z in (0, 1):
                k, sp = calc_ispec(g, var.isel(lev=z).values, **kw_ispec)
                sps.append(sp)
            stats[key + "r"] = xr.DataArray(
                np.stack(sps), ("lev", "kr"),
                {"lev": np.array([1, 2]), "kr": k})
            k, sp = calc_ispec(g, ave_lev_da(var, delta).values, **kw_ispec)
            stats[key + "r_mean"] = xr.DataArray(sp, ("kr",), {"kr": k})
        else:
            k, sp = calc_ispec(g, var.values, **kw_ispec)
            stats[key + "r"] = xr.DataArray(sp, ("kr",), {"kr": k})

    # energy-budget sums (closure check: Energysumr ~ 0 in steady state)
    budget = 0.0
    for key in ("KEfluxr", "APEfluxr", "APEgenspecr", "KEfrictionspecr",
                "paramspec_APEfluxr", "paramspec_KEfluxr", "Dissspecr"):
        if key in stats:
            budget = budget + stats[key].values
    stats["Energysumr"] = xr.DataArray(np.asarray(budget),
                                       stats["KEfluxr"].dims
                                       if "KEfluxr" in stats else ())
    eflux = 0.0
    for key in ("KEfluxr", "APEfluxr", "paramspec_KEfluxr",
                "paramspec_APEfluxr"):
        if key in stats:
            eflux = eflux + stats[key].values
    stats["Efluxr"] = xr.DataArray(np.asarray(eflux),
                                   stats["KEfluxr"].dims
                                   if "KEfluxr" in stats else ())

    # KE(t) depth-weighted
    dims = tuple(d for d in ds["u"].dims if d not in ("time",))
    ke_da = xr.DataArray(KE, ds["u"].dims, ds["u"].coords)
    stats["KE_time"] = ave_lev_da(ke_da, delta).mean(
        tuple(d for d in ds["u"].dims if d not in ("time", "lev")))
    return stats


def _cache_path(path: str) -> str:
    d = os.path.dirname(path)
    name = os.path.basename(path).encode("utf-8").hex() + ".cache_npz.npz"
    return os.path.join(d, name)


def _source_fingerprint(path: str) -> str:
    """Fingerprint of the glob's source files (names + sizes + mtimes), so a
    re-generated run invalidates its stale sidecar cache — the reference's
    hex-named cache (comparison_tools.py:273-278) silently survives re-runs."""
    import glob as _glob
    import hashlib
    items = []
    for f in sorted(_glob.glob(path)):
        if f.endswith(".cache_npz.npz"):
            continue
        st = os.stat(f)
        items.append(f"{os.path.basename(f)}:{st.st_size}:{st.st_mtime_ns}")
    return hashlib.sha256("|".join(items).encode()).hexdigest()[:16]


def dataset_smart_read(path: str, delta: float = 0.25,
                       read_cache: bool = True,
                       compute_all: bool = True) -> xr.Dataset:
    """Open a multi-run glob of .npz datasets, compute derived statistics and
    cache them to a hex-named sidecar (reference comparison_tools.py:273-410).
    The sidecar records a fingerprint of the source files and is recomputed
    if any source was re-generated since the cache was written."""
    cache = _cache_path(path)
    fp = _source_fingerprint(path)
    ds = xr.open_mfdataset(path, "run")
    if os.path.exists(cache) and read_cache:
        stats = xr.Dataset.from_npz(cache)
        if stats.attrs.get("source_fingerprint", "") == fp:
            return ds.update(stats)
    if os.path.exists(cache):
        os.remove(cache)
    stats = dataset_statistics(ds, delta=delta, compute_all=compute_all)
    stats.attrs["source_fingerprint"] = fp
    stats.to_npz(cache)
    return ds.update(stats)
