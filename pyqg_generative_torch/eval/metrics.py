"""Verbatim copy of `pyqg_generative_tpu/eval/metrics.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Scalar offline metrics: PDF histograms and subgrid scores.

Re-implementation of the reference's `tools/computational_tools.py` on the
xrlite data layer.
"""
from __future__ import annotations

import numpy as np

from ..qg.spectral import spectrum
from ..utils import xrlite as xr

__all__ = ["PDF_histogram", "subgrid_scores"]


def PDF_histogram(x: np.ndarray, xmin=None, xmax=None, Nbins: int = 30):
    """Density-normalized histogram of a 1D sample
    (reference tools/computational_tools.py:5-36)."""
    x = np.asarray(x).ravel()
    N = x.shape[0]
    mean, sigma = x.mean(), x.std()
    if xmin is None:
        xmin = mean - 4 * sigma
    if xmax is None:
        xmax = mean + 4 * sigma
    bandwidth = (xmax - xmin) / Nbins
    hist, edges = np.histogram(x, range=(xmin, xmax), bins=Nbins)
    density = hist / N / bandwidth
    points = 0.5 * (edges[:-1] + edges[1:])
    return points, density


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num/den with 0/0 -> 0 and x/0 -> inf-free large value, so degenerate
    layers (zero-variance truth, e.g. deterministic closures or constant
    fields in tests) don't emit RuntimeWarnings or NaNs."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    out = np.zeros_like(num)
    ok = den != 0
    np.divide(num, den, out=out, where=ok)
    out[~ok & (num != 0)] = np.finfo(np.float64).max
    return out


def _per_layer_R2(x: xr.DataArray, x_true: xr.DataArray) -> float:
    dims = tuple(d for d in x.dims if d != "lev")
    mse = ((x - x_true) ** 2).mean(dims)
    var = x_true.var(dims)
    return float(np.mean(1.0 - _safe_div(mse.values, var.values)))


def _per_layer_L2(x: xr.DataArray, x_true: xr.DataArray) -> float:
    dims = tuple(d for d in x.dims if d != "lev")
    num = ((x - x_true) ** 2).mean(dims)
    den = (x_true ** 2).mean(dims)
    return float(np.mean(np.sqrt(_safe_div(num.values, den.values))))


def subgrid_scores(true: xr.DataArray, mean: xr.DataArray,
                   gen: xr.DataArray) -> xr.Dataset:
    """R2/L2 of the mean prediction, of the generated *spectrum*, and of the
    generated residual spectrum, plus per-layer residual variance ratio
    (reference tools/computational_tools.py:38-84)."""
    ds = xr.Dataset()
    ds["R2_mean"] = _per_layer_R2(mean, true)
    ds["L2_mean"] = _per_layer_L2(mean, true)

    sp = spectrum(time=slice(None, None))
    sp_true = sp(true)
    sp_gen = sp(gen)
    ds["sp_true"] = sp_true
    ds["sp_gen"] = sp_gen
    ds["R2_total"] = _per_layer_R2(sp_gen, sp_true)
    ds["L2_total"] = _per_layer_L2(sp_gen, sp_true)

    sp_true_res = sp(true - mean)
    sp_gen_res = sp(gen - mean)
    ds["sp_true_res"] = sp_true_res
    ds["sp_gen_res"] = sp_gen_res
    ds["R2_residual"] = _per_layer_R2(sp_gen_res, sp_true_res)
    ds["L2_residual"] = _per_layer_L2(sp_gen_res, sp_true_res)

    gen_res = gen - mean
    true_res = true - mean
    dims = tuple(d for d in mean.dims if d != "lev")
    ds["var_ratio"] = xr.DataArray(
        _safe_div((gen_res ** 2).mean(dims).values,
                  (true_res ** 2).mean(dims).values),
        dims=("lev",))
    return ds
