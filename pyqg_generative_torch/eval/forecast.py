"""Verbatim copy of `pyqg_generative_tpu/eval/forecast.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Ensemble-forecast skill metrics.

The reference's forecasting stage (scripts/run_forecasting.py:8-62 +
tools/simulate.py:254-293) launches, per initial condition, an N_ens-member
ensemble from a coarse-grained 256^2 reference snapshot and saves member-0
plus the ensemble mean of (q, u, v, psi) at daily resolution. The skill
analysis itself lives in the paper's notebooks; this module provides it as
code:

* ``ensemble_skill``: RMSE of the ensemble mean against the verifying
  member (member-0, the standard perfect-model proxy for truth given that
  forecasts start at the *end* of the reference trajectories);
* ``ensemble_spread``: mean ensemble standard deviation (saved by
  ``exp.pipeline.run_forecasting`` as ``<var>_std``);
* ``spread_skill_dataset``: per-lead-time curves aggregated over initial
  conditions, including the reliability-normalized ratio
  ``spread * sqrt((M+1)/M) / rmse`` (== 1 for a perfectly reliable
  ensemble);
* ``forecast_skill_table``: the decorrelation-sweep table used in
  docs/VALIDATION.md.

All reductions are depth-weighted with the layer-thickness ratio ``delta``
as elsewhere in the metric stack (reference tools/operators.py:12-27).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..utils import xrlite as xr

__all__ = ["ensemble_skill", "ensemble_spread", "spread_skill_dataset",
           "forecast_skill_table"]
# (ensemble_skill accepts an independent truth dataset — see its docstring;
# spread_skill_dataset picks up truth_{n}.npz files automatically)


def _ave_lev(arr: np.ndarray, delta: float, axis: int) -> np.ndarray:
    """Depth-weighted layer mean: (delta*upper + lower) / (1 + delta)."""
    up = np.take(arr, 0, axis=axis)
    lo = np.take(arr, 1, axis=axis)
    return (delta * up + lo) / (1.0 + delta)


def _space_rms(x: np.ndarray) -> np.ndarray:
    """RMS over the trailing (y, x) axes."""
    return np.sqrt(np.mean(x ** 2, axis=(-2, -1)))


def _reduced_lev_axis(dims) -> int:
    """Negative position of 'lev' after the (y, x) axes are reduced away."""
    reduced = [d for d in dims if d not in ("y", "x")]
    return reduced.index("lev") - len(reduced)


def ensemble_skill(ds: xr.Dataset, var: str = "q",
                   delta: float = 0.25,
                   ds_truth: xr.Dataset | None = None) -> np.ndarray:
    """RMSE(time,) of the ensemble mean vs the verifying trajectory,
    depth-weighted, normalized by the verifier's RMS amplitude so that
    1.0 == no skill beyond climatology-free saturation.

    Verifier: member-0 (the reference's perfect-model protocol) unless
    `ds_truth` is given — an independent truth dataset (the coarse-grained
    256^2 continuation written by exp.pipeline.run_forecast_truth), in
    which case the skill includes real coarse-model error."""
    truth = (ds_truth if ds_truth is not None else ds)[var].values
    mean = ds[var + "_mean"].values
    nt = min(truth.shape[0], mean.shape[0])
    truth, mean = truth[:nt], mean[:nt]
    err = _space_rms(truth - mean)          # (time, lev)
    amp = _space_rms(truth)
    lev_axis = _reduced_lev_axis(ds[var].dims)
    return (_ave_lev(err, delta, lev_axis)
            / np.maximum(_ave_lev(amp, delta, lev_axis), 1e-300))


def ensemble_spread(ds: xr.Dataset, var: str = "q",
                    delta: float = 0.25) -> np.ndarray:
    """Normalized ensemble spread(time,): mean ensemble std over space,
    depth-weighted, normalized like `ensemble_skill`. Requires the
    ``<var>_std`` field saved by run_forecasting."""
    std = ds[var + "_std"].values
    amp = _space_rms(ds[var].values)
    spread = _space_rms(std)
    lev_axis = _reduced_lev_axis(ds[var].dims)
    return (_ave_lev(spread, delta, lev_axis)
            / np.maximum(_ave_lev(amp, delta, lev_axis), 1e-300))


def spread_skill_dataset(folder: str, var: str = "q", n_ens: int | None = None,
                         delta: float = 0.25) -> xr.Dataset:
    """Aggregate all ICs in a forecast folder (one npz per IC, as written by
    exp.pipeline.run_forecasting) into per-lead-time curves.

    Returns a dataset with dims (time,):
      rmse        — IC-mean normalized ensemble-mean RMSE vs member-0
      spread      — IC-mean normalized ensemble spread
      ratio       — spread * sqrt((M+1)/M) / rmse (1 == reliable), if
                    n_ens (M) is given; else plain spread/rmse.
    """
    files = sorted(f for f in glob.glob(os.path.join(folder, "*.npz"))
                   if not os.path.basename(f).startswith("truth_"))
    if not files:
        raise FileNotFoundError(f"no forecast files in {folder}")
    skills, spreads = [], []
    n_legacy = 0
    for path in files:
        ds = xr.Dataset.from_npz(path)
        # independent truth, if run_forecast_truth wrote one for this IC
        # (searched next to the forecast and one level up, where the truth
        # is shared across decorrelation subfolders)
        stem = os.path.splitext(os.path.basename(path))[0]
        ds_truth = None
        for tdir in (folder, os.path.dirname(folder)):
            tpath = os.path.join(tdir, f"truth_{stem}.npz")
            if os.path.exists(tpath):
                ds_truth = xr.Dataset.from_npz(tpath)
                break
        skills.append(ensemble_skill(ds, var, delta, ds_truth=ds_truth))
        if var + "_std" in ds:
            spreads.append(ensemble_spread(ds, var, delta))
        # run_forecasting records the member count actually used in the
        # saved mean/std (member-0 excluded); prefer it over the caller's
        # n_ens so the reliability factor matches the data.
        if "n_ens_stat" in ds.attrs:
            if n_ens is None:
                n_ens = int(ds.attrs["n_ens_stat"])
        else:
            n_legacy += 1
    if n_legacy:
        import warnings
        warnings.warn(
            f"spread_skill_dataset: {n_legacy}/{len(files)} forecast files "
            f"in {folder} predate the n_ens_stat attribute (their saved "
            "mean/std include member-0, biasing RMSE low and the "
            "reliability factor); output is tagged "
            "'n_legacy_member0_files' — do not mix with new-format "
            "folders in cross-round comparisons", stacklevel=2)
    rmse = np.mean(np.stack(skills), axis=0)
    out = xr.Dataset()
    out["rmse"] = xr.DataArray(rmse, ("time",))
    if spreads:
        spread = np.mean(np.stack(spreads), axis=0)
        out["spread"] = xr.DataArray(spread, ("time",))
        factor = np.sqrt((n_ens + 1) / n_ens) if n_ens else 1.0
        out["ratio"] = xr.DataArray(
            factor * spread / np.maximum(rmse, 1e-300), ("time",))
    out.attrs["n_ic"] = len(files)
    out.attrs["n_legacy_member0_files"] = n_legacy
    return out


def forecast_skill_table(base: str, decorrelations=(0, 12, 24, 36, 48),
                         var: str = "q", n_ens: int | None = None,
                         days=(1, 10, 30, 60, 90),
                         subfolder: str = "forecast") -> dict:
    """Decorrelation-sweep summary: {dec: {'rmse': {day: v}, 'spread': ...,
    'ratio': ...}} sampled at the requested lead times (daily snapshots)."""
    table = {}
    for dec in decorrelations:
        folder = os.path.join(base, subfolder, f"decorrelation-{dec}h")
        if not os.path.isdir(folder):
            continue
        ds = spread_skill_dataset(folder, var, n_ens)
        nt = ds["rmse"].shape[0]
        row = {}
        for key in ("rmse", "spread", "ratio"):
            if key in ds:
                row[key] = {d: float(ds[key].values[min(d - 1, nt - 1)])
                            for d in days if d - 1 < nt}
        table[dec] = row
    return table
