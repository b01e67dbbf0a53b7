"""The JAMES paper's experiment matrix as functions: references, forcing
data, training, online runs, forecasts and online scores.

Twin of `pyqg_generative_tpu/exp/pipeline.py`, each stage with its twin's
arguments, folder layout and file names, so that either package reads what
the other wrote, and a `device` (None means CUDA) that each stage hands to
the drivers, the models and the operators. Two stages differ from the twin:

* `run_forcing_datasets` takes `operators`, by default Operator1 and
  Operator2, the pair `train_parameterizations` reads; the twin calls
  `generate_subgrid_forcing` with its default (Operator2, Operator5), which
  writes no `Operator1-*` folder, so its two stages do not chain (ROADMAP,
  queue 3). It also advances `batch` runs together
  (`generate_subgrid_forcing_batch`), each run's file that of its own key;
* the forecast truth coarse-grains with the port's operator on the device,
  where the twin jits its own.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..eval.comparison import (coarsegrain_reference_dataset,
                               diagnostic_differences, distrib_score,
                               spectral_score)
from ..models import MODEL_REGISTRY, load_model
from ..qg.operators import OPERATORS
from ..qg.params import ANDREW_1000_STEPS, DAY, EDDY_PARAMS, JET_PARAMS, YEAR
from ..sim import generate_subgrid_forcing_batch, run_ensemble
from ..utils import xrlite as xr

__all__ = ["CONFIGURATIONS", "run_reference", "run_forcing_datasets",
           "train_parameterizations", "run_parameterized",
           "forecast_initial_conditions", "run_forecasting",
           "run_forecast_truth", "train_ANN", "coarse_target_cached",
           "compute_online_metrics", "run_splits", "coarsen"]

CONFIGURATIONS = {"eddy": EDDY_PARAMS, "jet": JET_PARAMS}


def run_reference(base: str, configuration: str = "eddy",
                  resolutions=(48, 64, 96, 128, 256), n_ens: int = 10,
                  years: float = 20.0,
                  sampling_freq: float = ANDREW_1000_STEPS, device=None):
    """Unparameterized references of n_ens members at each resolution, one
    file a member in {base}/{configuration}/reference_{nx}/ (twin :25-40)."""
    p0 = CONFIGURATIONS[configuration]
    for nx in resolutions:
        p = p0.with_nx(nx).replace(tmax=years * YEAR,
                                   tavestart=years * YEAR / 2)
        folder = os.path.join(base, configuration, f"reference_{nx}")
        os.makedirs(folder, exist_ok=True)
        ds = run_ensemble(p, n_ens=n_ens, sampling_freq=sampling_freq,
                          device=device)
        for j in range(n_ens):
            ds.isel(run=j).to_npz(os.path.join(folder, f"{j}.npz"))


def run_forcing_datasets(base: str, configuration: str = "eddy",
                         n_runs: int = 300, Nc=(32, 48, 64, 96, 128),
                         dns_nx: int = 256, years: float = 10.0,
                         sampling_freq: float = ANDREW_1000_STEPS,
                         operators=("Operator1", "Operator2"),
                         batch: int = 8, device=None):
    """DNS runs at dns_nx^2, each writing one forcing dataset a (operator,
    resolution) to {base}/{configuration}/{operator}-{nc}-dealias/{run}.npz
    (twin :43-57). Run r starts from `set_initial_condition(p, r)`; `batch`
    runs advance together, each file that of `generate_subgrid_forcing`
    with key r."""
    p = CONFIGURATIONS[configuration].with_nx(dns_nx).replace(
        tmax=years * YEAR)
    for run0 in range(0, n_runs, batch):
        keys = list(range(run0, min(run0 + batch, n_runs)))
        outs = generate_subgrid_forcing_batch(
            list(Nc), p, sampling_freq, operators=tuple(operators),
            keys=keys, device=device)
        for run, out in zip(keys, outs):
            for name, ds in out.items():
                folder = os.path.join(base, configuration, name)
                os.makedirs(folder, exist_ok=True)
                ds.to_npz(os.path.join(folder, f"{run}.npz"))


def run_splits(nrun: int, train_frac=(0.0, 0.833, 0.917, 1.0)):
    """The train, validation and test slices of `nrun` runs (twin :76-80;
    reference tools/train_model.py:36-55)."""
    cuts = [int(f * nrun) for f in train_frac]
    return [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]


def train_parameterizations(base: str, configuration: str = "eddy",
                            models=("MeanVarModel", "CGANRegression",
                                    "CVAERegression"),
                            operators=("Operator1", "Operator2"),
                            resolutions=(48, 64, 96), realizations=5,
                            fit_kw=None, ensemble_size: int = 1000,
                            train_frac=(0.0, 0.833, 0.917, 1.0),
                            device=None):
    """The {GZ, GAN, VAE} x operators x resolutions x seeds matrix (twin
    :59-99): each closure trained on the runs' train split, validated on
    the next, scored offline on the last into offline_test.npz, in
    {base}/{configuration}/models_{op}_{nx}/{model}-{seed}; a folder that
    holds model_args.json is skipped. Seed s is `fit`'s key, but for
    MeanVarModel, whose fit takes none."""
    for model_name in models:
        for op in operators:
            for nx in resolutions:
                data = os.path.join(base, configuration,
                                    f"{op}-{nx}-dealias", "*.npz")
                ds = xr.open_mfdataset(data, "run")
                s_train, s_val, s_test = run_splits(
                    ds["q"].sizes()["run"], train_frac)
                ds_train = ds.isel(run=s_train)
                ds_val = ds.isel(run=s_val)
                ds_test = ds.isel(run=s_test)
                for seed in range(realizations):
                    folder = os.path.join(
                        base, configuration, f"models_{op}_{nx}",
                        f"{model_name}-{seed}")
                    if os.path.exists(os.path.join(folder,
                                                   "model_args.json")):
                        continue
                    kw = dict(fit_kw or {})
                    extra = {"nx": nx} if model_name == "CGANRegression" \
                        else {}
                    model = MODEL_REGISTRY[model_name](
                        folder=folder, device=device, **extra)
                    if model_name != "MeanVarModel":
                        kw["key"] = seed
                    model.fit(ds_train, ds_val, **kw)
                    model.test_offline(ds_test, ensemble_size).to_npz(
                        os.path.join(folder, "offline_test.npz"))


def run_parameterized(base: str, model_folder: str,
                      configuration: str = "eddy", nx: int = 64,
                      n_ens: int = 10, years: float = 20.0,
                      sampling: str = "AR1", nsteps: int = 1,
                      subfolder: str = "online",
                      sampling_freq: float = ANDREW_1000_STEPS, device=None):
    """n_ens online members of a trained closure, one file a member in
    {model_folder}/{subfolder}/ (twin :101-119)."""
    p = CONFIGURATIONS[configuration].with_nx(nx).replace(
        tmax=years * YEAR, tavestart=years * YEAR / 2)
    model = load_model(model_folder, device=device)
    ds = run_ensemble(p, {"self": model, "sampling": sampling,
                          "nsteps": nsteps},
                      n_ens=n_ens, sampling_freq=sampling_freq,
                      device=device)
    folder = os.path.join(model_folder, subfolder)
    os.makedirs(folder, exist_ok=True)
    for j in range(n_ens):
        ds.isel(run=j).to_npz(os.path.join(folder, f"{j}.npz"))
    return ds


def _runs_by_number(pattern: str) -> dict:
    """Run number -> file, by the number in the file's name: a sorted glob
    puts '10' before '2'."""
    def number(path):
        stem = os.path.splitext(os.path.basename(path))[0]
        return int(stem) if stem.isdigit() else -1

    return {number(f): f for f in glob.glob(pattern) if number(f) >= 0}


def _ic_snapshot(by_number: dict, number: int):
    """IC `number`'s PV (lev, y, x) at its reference resolution, or None:
    IC j < 10 is the last snapshot of run j, IC j >= 10 snapshot -30 of run
    j - 10 (reference scripts/run_forecasting.py:52-56)."""
    run, tsel = (number, -1) if number < 10 else (number - 10, -30)
    if run not in by_number:
        return None
    q = xr.Dataset.from_npz(by_number[run])["q"].isel(time=tsel).values
    return q[0] if q.ndim == 4 else q


def coarsen(q, operator: str, nx: int, device=None) -> np.ndarray:
    """The array q coarse-grained to nx by `operator` on `device` (None
    means CUDA), back as numpy."""
    device = resolve_device(device)
    return OPERATORS[operator](torch.as_tensor(q, device=device),
                               nx).cpu().numpy()


def forecast_initial_conditions(reference_glob: str, nx: int,
                                operator: str, n_ic: int = 15,
                                device=None):
    """(number, q_init (lev, nx, nx)) of each forecast IC found (twin
    :122-153): its reference snapshot coarse-grained to nx with the training
    operator on `device`."""
    device = resolve_device(device)
    by_number = _runs_by_number(reference_glob)
    for number in range(n_ic):
        q = _ic_snapshot(by_number, number)
        if q is not None:
            yield number, coarsen(q, operator, nx, device)


def _use_epoch(model, epoch: str, model_folder: str):
    """Switch a loaded closure to its 'opt' or 'stable' weights."""
    loaders = {"opt": getattr(model, "use_optimal_epoch", lambda: False),
               "stable": getattr(model, "use_stable_epoch", lambda: False)}
    if epoch not in loaders:
        raise ValueError(f"epoch must be one of 'final', 'opt', 'stable'; "
                         f"got {epoch!r}")
    if not loaders[epoch]():
        raise FileNotFoundError(
            f"no banked '{epoch}' generator weights in {model_folder}")


def run_forecasting(base: str, model_folder: str | None,
                    ic_glob: str, configuration: str = "eddy",
                    nx: int = 64, n_ic: int = 15, n_ens: int = 15,
                    decorrelations=(0, 12, 24, 36, 48), days: float = 90.0,
                    sampling: str = "AR1", operator: str = "Operator2",
                    subfolder: str = "forecast", epoch: str = "final",
                    device=None):
    """Ensemble forecasts of n_ic ICs x n_ens members at each noise
    decorrelation time (hours; 0 is white noise), daily snapshots, into
    {base}/{subfolder}/decorrelation-{h}h/{number}.npz (twin :156-211):
    member 0's (q, u, v, psi) and the mean and std of the other n_ens - 1
    members, `n_ens_stat` in the attributes."""
    p = CONFIGURATIONS[configuration].with_nx(nx).replace(
        tmax=days * DAY, tavestart=days * DAY)
    model = load_model(model_folder, device=device) if model_folder \
        else None
    if model is not None and epoch != "final":
        _use_epoch(model, epoch, model_folder)
    ics = list(forecast_initial_conditions(ic_glob, nx, operator, n_ic,
                                           device))
    for dec in decorrelations:
        nsteps = max(1, int(round(dec * 3600.0 / p.dt)))
        for number, q_init in ics:
            param = None if model is None else \
                {"self": model, "sampling": sampling, "nsteps": nsteps}
            ds = run_ensemble(p, param, n_ens=n_ens, q_init=q_init,
                              sampling_freq=DAY, key=number,
                              with_diags=False, device=device)
            out = xr.Dataset(attrs=ds.attrs)
            for var in ("q", "u", "v", "psi"):
                out[var] = ds[var].isel(run=0)
                rest = ds[var].isel(run=slice(1, None))
                out[var + "_mean"] = rest.mean("run")
                out[var + "_std"] = rest.std("run")
            out.attrs["n_ens_stat"] = n_ens - 1
            folder = os.path.join(base, subfolder, f"decorrelation-{dec}h")
            os.makedirs(folder, exist_ok=True)
            out.to_npz(os.path.join(folder, f"{number}.npz"))


def run_forecast_truth(base: str, ic_glob: str, configuration: str = "eddy",
                       nx: int = 64, operator: str = "Operator2",
                       n_ic: int = 15, days: float = 90.0,
                       subfolder: str = "forecast", truth_nx: int = 256,
                       device=None):
    """The verifying truth of each forecast IC: its truth_nx^2 reference
    continued for `days` in single precision, coarse-grained to nx with
    `operator`, daily, into {base}/{subfolder}/truth_{number}.npz; an
    existing file is kept (twin :214-271)."""
    device = resolve_device(device)
    p_hi = CONFIGURATIONS[configuration].with_nx(truth_nx).replace(
        tmax=days * DAY, tavestart=days * DAY, precision="single")
    by_number = _runs_by_number(ic_glob)
    folder = os.path.join(base, subfolder)
    os.makedirs(folder, exist_ok=True)
    for number in range(n_ic):
        out_path = os.path.join(folder, f"truth_{number}.npz")
        if os.path.exists(out_path):
            continue
        q = _ic_snapshot(by_number, number)
        if q is None:
            continue
        ds = run_ensemble(p_hi, None, n_ens=1, q_init=np.asarray(q),
                          sampling_freq=DAY, key=number, with_diags=False,
                          device=device)
        out = xr.Dataset(attrs={"ic_number": number, "operator": operator,
                                "nx": nx})
        for var in ("q", "u", "v", "psi"):
            coarse = coarsen(ds[var].isel(run=0).values, operator, nx,
                              device)
            out[var] = xr.DataArray(coarse.astype("float32"),
                                    ("time", "lev", "y", "x"))
        out.to_npz(out_path)


def train_ANN(base: str, configurations=("eddy", "jet"),
              resolutions=(48, 96), operator: str = "Operator2",
              folder_name: str = "ann_model", fit_kw=None, device=None):
    """One ANN on every (configuration, resolution)'s first 90% of runs,
    scored offline on the rest of each into offline_{cfg}-{nx}.npz (twin
    :274-296)."""
    from ..models.ann_model import ANNModel
    train_sets, test_sets = [], []
    for cfg in configurations:
        for nx in resolutions:
            data = os.path.join(base, cfg, f"{operator}-{nx}-dealias",
                                "*.npz")
            ds = xr.open_mfdataset(data, "run")
            nrun = ds["q"].sizes()["run"]
            train_sets.append(ds.isel(run=slice(0, int(0.9 * nrun))))
            test_sets.append(ds.isel(run=slice(int(0.9 * nrun), nrun)))
    folder = os.path.join(base, folder_name)
    model = ANNModel(folder=folder, device=device)
    model.fit(train_sets, test_sets, **(fit_kw or {}))
    for cfg_ds, name in zip(test_sets, [f"{c}-{n}" for c in configurations
                                        for n in resolutions]):
        model.test_offline(cfg_ds, ensemble_size=2).to_npz(
            os.path.join(folder, f"offline_{name}.npz"))
    return model


def coarse_target_cached(reference_glob: str, operator: str,
                         resolution: int, device=None) -> xr.Dataset:
    """The reference runs coarse-grained to `resolution` by `operator`,
    cached beside them as .coarse_{operator}_{resolution}.npz, the twin's
    name and layout, written atomically (twin :299-316)."""
    cache = os.path.join(os.path.dirname(reference_glob),
                         f".coarse_{operator}_{resolution}.npz")
    if os.path.exists(cache):
        return xr.Dataset.from_npz(cache)
    ref = xr.open_mfdataset(reference_glob, "run")
    target = coarsegrain_reference_dataset(ref, resolution, operator,
                                           device=device)
    try:
        target.to_npz(cache)
    except OSError:
        pass
    return target


def compute_online_metrics(base: str, model_folder: str, reference_glob: str,
                           operator: str, resolution: int,
                           subfolder: str = "online",
                           save_file: str = "metrics.json", T: int = 128,
                           device=None):
    """The online runs in {model_folder}/{subfolder}/ against the
    coarse-grained reference: the normalized differences, distrib_score,
    spectral_score and the folder's name as `key`, written to
    {model_folder}/{save_file} (twin :318-335)."""
    model_ds = xr.open_mfdataset(
        os.path.join(model_folder, subfolder, "*.npz"), "run")
    target = coarse_target_cached(reference_glob, operator, resolution,
                                  device)
    norm, _, _ = diagnostic_differences(model_ds, target, T=T)
    norm["distrib_score"] = distrib_score(norm)
    norm["spectral_score"] = spectral_score(norm)
    norm["key"] = os.path.basename(model_folder)
    with open(os.path.join(model_folder, save_file), "w") as f:
        json.dump(norm, f)
    return norm
