"""Parameterization base class (online hooks and the offline harness), the
model registry and the folder contract's writers.

Twin of `pyqg_generative_tpu/models/base.py` (:43-273): a closure maps PV
snapshots (..., lev, ny, nx) and latent noise (..., model-defined shape) to a
PV forcing, with the spatial mean removed per layer. Leading axes are ensemble
members. `save_model_args` and `save_variables` write the twin's folder
contract (`model_args.json`, flax msgpack weights, written with `msgpack`
alone), and `load_variables` reads a weights file against a template tree.
`fit` trains a closure on a forcing dataset (each closure's own). Offline,
`predict` maps a dataset of snapshots to the forcing's sample, mean and
variance, and `test_offline` turns them into the twin's metric dataset, key for
key and dim for dim, on the host in numpy; `extract`, `array_to_dataset` and
`prepare_PV_data` move between datasets and NHWC arrays as the twin's do.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..eval.metrics import PDF_histogram, subgrid_scores
from ..ml.scalers import ChannelwiseScaler
from ..ml.weights import read_msgpack, to_msgpack_bytes
from ..qg.params import AVERAGE_SLICE_ANDREW
from ..qg.spectral import spectrum
from ..utils import xrlite as xr

__all__ = ["Parameterization", "register_model", "load_model",
           "MODEL_REGISTRY", "save_model_args", "save_variables",
           "load_variables", "extract", "array_to_dataset", "prepare_PV_data"]

MODEL_REGISTRY: dict[str, type] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.__name__] = cls
    return cls


def load_model(folder: str = "model", device=None, **overrides):
    """Reload a saved model from its folder (the `model_args.json` contract
    the JAX package writes). `overrides` replace saved constructor arguments,
    e.g. `online_variant="tap"`; `device=None` means CUDA."""
    with open(os.path.join(folder, "model_args.json")) as f:
        args = json.load(f)
    name = args.pop("model")
    args.update(overrides)
    return MODEL_REGISTRY[name](folder=folder, device=device, **args)


def save_model_args(model_name: str, folder: str = "model", **kw):
    """`model_args.json`: the class name and its constructor arguments."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "model_args.json"), "w") as f:
        json.dump({"model": model_name, **kw}, f)


def save_variables(variables: dict, path: str):
    """A flax variable tree (numpy or torch arrays) as the bytes flax's
    `serialization.to_bytes` writes."""
    with open(path, "wb") as f:
        f.write(to_msgpack_bytes(variables))


def _layout(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_layout(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(np.shape(tree))}


def load_variables(template: dict, path: str) -> dict:
    """The flax tree in the weights file `path`, checked against
    `template`: the same paths and shapes, as flax's `from_bytes(template,
    ...)` restores it (twin :69)."""
    tree = read_msgpack(path)
    want, got = _layout(template), _layout(tree)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:5]
        raise ValueError(f"{path} does not match its template: {diff}")
    return tree


# --------------------------------------------------------------------------
# dataset <-> NHWC arrays (reference tools/cnn_tools.py:398-456)
# --------------------------------------------------------------------------

def extract(ds: xr.Dataset, key: str) -> np.ndarray:
    """(run, time, lev, y, x) -> (batch, ny, nx, lev) float32 NHWC."""
    var = ds[key]
    for d in ("run", "time"):
        if d not in var.dims:
            var = var.expand_dims(d)
    v = var.transpose("run", "time", "lev", "y", "x").values
    v = v.reshape(-1, *v.shape[2:])            # (batch, lev, y, x)
    return np.moveaxis(v, 1, -1).astype("float32")


def array_to_dataset(ds: xr.Dataset, array: np.ndarray, name: str,
                     dims=("run", "time", "lev", "y", "x")) -> xr.DataArray:
    """NHWC (batch, ny, nx, lev) back to the dataset's (run,time,lev,y,x)."""
    q = ds["q"]
    for d in ("run", "time"):
        if d not in q.dims:
            q = q.expand_dims(d)
    shape = q.transpose("run", "time", "lev", "y", "x").shape
    arr = np.moveaxis(array, -1, 1).reshape(shape)
    return xr.DataArray(arr, dims=dims)


def prepare_PV_data(ds_train: xr.Dataset, ds_test: xr.Dataset):
    """Extract PV -> forcing pairs and normalize per channel
    (reference tools/cnn_tools.py:402-421)."""
    X_train = extract(ds_train, "q")
    Y_train = extract(ds_train, "q_forcing_advection")
    X_test = extract(ds_test, "q")
    Y_test = extract(ds_test, "q_forcing_advection")
    x_scale = ChannelwiseScaler(X_train)
    y_scale = ChannelwiseScaler(Y_train)
    return (x_scale.normalize(X_train), y_scale.normalize(Y_train),
            x_scale.normalize(X_test), y_scale.normalize(Y_test),
            x_scale, y_scale)


# --------------------------------------------------------------------------


def _corr(a: xr.DataArray, b: xr.DataArray, dims) -> xr.DataArray:
    am = a - a.mean(dims)
    bm = b - b.mean(dims)
    cov = (am * bm).mean(dims)
    return cov / ((a.std(dims)) * (b.std(dims)))


class Parameterization:
    """Abstract stochastic subgrid closure.

    `weights_generation` counts the weight sets a model has loaded: a model
    that switches weights (`load_model`, `use_optimal_epoch`, ...) drops
    what it derived from the old ones and adds one, and a `GraphedStep`
    captured under one generation never replays under another."""

    weights_generation = 0

    def latent_shape(self, ny: int, nx: int) -> tuple:
        """Shape of one member's latent noise (NHWC, channels last)."""
        return (ny, nx, 0)

    def generate_latent_noise(self, generator: torch.Generator, ny: int,
                              nx: int, batch_shape=()) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + self.latent_shape(ny, nx),
                           dtype=torch.float32, device=generator.device)

    def predict_snapshot(self, q: torch.Tensor, noise: torch.Tensor):
        raise NotImplementedError

    def predict_mean_snapshot(self, q: torch.Tensor, M: int = 100):
        raise NotImplementedError

    def fit(self, ds_train, ds_test, **kw):
        """Train on a forcing dataset and save into `self.folder`."""
        raise NotImplementedError

    def predict(self, ds: xr.Dataset, M: int = 1000) -> xr.Dataset:
        """The dataset's forcing: a sample, its mean and variance over M
        draws, as `q_forcing_advection`, `..._mean` and `..._var`."""
        raise NotImplementedError

    def __call__(self, q, noise):
        """Online forcing: prediction with the spatial mean removed per layer
        (reference models/parameterization.py:23-34)."""
        pred = self.predict_snapshot(q, noise)
        return pred - pred.mean(dim=(-2, -1), keepdim=True)

    # hooks of the online step; ML closures see only q
    def online_forcing(self, flds, noise, p):
        return self(flds.q, noise)

    def online_mean_forcing(self, flds, p):
        pred = self.predict_mean_snapshot(flds.q)
        return pred - pred.mean(dim=(-2, -1), keepdim=True)

    def test_offline(self, ds: xr.Dataset, ensemble_size: int = 1000) -> xr.Dataset:
        """Full offline-metric dataset (reference models/parameterization.py:36-169)."""
        target = "q_forcing_advection"
        preds = self.predict(ds, ensemble_size)
        out = xr.Dataset(attrs=dict(ds.attrs))
        out["q"] = ds["q"]
        gen = preds[target]
        true = ds[target].astype("float64")
        mean = preds[target + "_mean"].astype("float64")
        var = preds[target + "_var"]
        out[target] = ds[target]
        out[target + "_gen"] = gen
        out[target + "_mean"] = preds[target + "_mean"]
        out[target + "_var"] = var
        out[target + "_std"] = var ** 0.5
        res = true - mean
        gen_res = gen.astype("float64") - mean
        out[target + "_res"] = res
        out[target + "_gen_res"] = gen_res

        scores = subgrid_scores(out[target], out[target + "_mean"],
                                out[target + "_gen"])
        for k in ("R2_mean", "R2_total", "R2_residual",
                  "L2_mean", "L2_total", "L2_residual"):
            out[k] = scores[k]

        # Andrew metrics
        all_dims = out[target].dims
        time = tuple(d for d in all_dims if d not in ("x", "y", "lev"))
        space = tuple(d for d in all_dims if d not in ("time", "lev"))
        both = tuple(d for d in all_dims if d != "lev")

        error = (true - mean) ** 2
        out["spatial_mse"] = error.mean(time)
        out["temporal_mse"] = error.mean(space)
        out["mse"] = error.mean(both)
        out["temporal_sgs_ms"] = (true ** 2).mean(space)
        out["spatial_nmse"] = error.mean(time) / (true ** 2).mean(time)
        out["temporal_nmse"] = error.mean(space) / (true ** 2).mean(space)
        out["nmse"] = error.mean(both) / (true ** 2).mean(both)

        def limits(x):
            return xr.DataArray(np.minimum(np.maximum(x.values, -10), 1),
                                x.dims, x.coords)

        out["spatial_skill"] = limits(1 - out["spatial_mse"] / true.var(time))
        out["temporal_skill"] = limits(1 - out["temporal_mse"] / true.var(space))
        out["skill"] = limits(1 - out["mse"] / true.var(both))
        out["spatial_correlation"] = _corr(true, mean, time)
        out["temporal_correlation"] = _corr(true, mean, space)
        out["correlation"] = _corr(true, mean, both)
        out["temporal_var_ratio"] = (gen_res ** 2).mean(space) / \
            (res ** 2).mean(space)
        out["var_ratio"] = (gen_res ** 2).mean(both) / (res ** 2).mean(both)

        # spectral characteristics
        nt = out[target].sizes()["time"]
        tslice = AVERAGE_SLICE_ANDREW if nt > 44 else slice(None, None)
        sp = spectrum(time=tslice)
        for suffix, arr in (("", out[target]), ("_gen", gen),
                            ("_res", res), ("_gen_res", gen_res),
                            ("_mean", mean)):
            out["PSD" + suffix] = sp(
                arr, name="Power spectral density of dq/dt", units="m/s^4")

        co = spectrum(type="cospectrum", time=tslice)
        psi = ds["psi"]
        for suffix, arr in (("", out[target]), ("_gen", gen),
                            ("_res", res), ("_gen_res", gen_res),
                            ("_mean", mean)):
            out["Eflux" + suffix] = -1.0 * co(
                psi, arr, name="Energy contribution", units="m^3/s^3")

        def L2sp(x, x_true):
            dims = tuple(d for d in x.dims if d != "lev")
            return xr.DataArray(np.sqrt(
                ((x - x_true) ** 2).mean(dims).values /
                (x_true ** 2).mean(dims).values), dims=("lev",))

        out["L2_PSD"] = L2sp(out["PSD_gen"], out["PSD"])
        out["L2_Eflux"] = L2sp(out["Eflux_gen"], out["Eflux"])

        cl = spectrum(type="cross_layer", time=tslice)
        out["CSD_res"] = cl(res, name="Cross layer covariance", units="m/s^4")
        out["CSD_gen_res"] = cl(gen_res, name="Cross layer covariance",
                                units="m/s^4")

        # PDFs, sigma-normalized, 70 bins over +-5 RMS
        Nbins = 70
        for lev in (0, 1):
            arr = out[target].isel(time=tslice, lev=lev)
            std = float(arr.values.std())
            for suffix in ("", "_gen", "_mean"):
                vals = out[target + suffix].isel(
                    time=tslice, lev=lev).values.ravel() / std
                pts, density = PDF_histogram(vals, xmin=-5, xmax=5, Nbins=Nbins)
                out[f"PDF{suffix}{lev}"] = xr.DataArray(
                    density, dims=(f"q_{lev}",), coords={f"q_{lev}": pts})
        for lev in (0, 1):
            arr = out[target + "_res"].isel(time=tslice, lev=lev)
            std = float(arr.values.std())
            for suffix in ("_res", "_gen_res"):
                vals = out[target + suffix].isel(
                    time=tslice, lev=lev).values.ravel() / std
                pts, density = PDF_histogram(vals, xmin=-5, xmax=5, Nbins=Nbins)
                out[f"PDF{suffix}{lev}"] = xr.DataArray(
                    density, dims=(f"dq_{lev}",), coords={f"dq_{lev}": pts})

        return out.astype("float32")
