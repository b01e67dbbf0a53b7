"""Pointwise stencil MLP closure, online inference.

Twin of the online half of `pyqg_generative_tpu/models/ann_model.py`
(:29-38, :72-86, :113-133): an MLP maps each (stencil_size x stencil_size)
circular patch of one level's PV, divided by the saved `x_scale`, to the
forcing at its centre, times `y_scale` (both scalars in `scale.json`);
optionally scale-invariant, norm^2 * f(x / norm). The twin runs it through
XLA, so the port runs its dense layers through cuBLAS under `exact_fp32`,
online and in the offline `predict` (twin :141-157, batches of 256 level
fields). `fit` trains it by MSE regression on stencils subsampled every third
point (`prepare_data_ANN`, twin :51-72), and `save_model` writes the twin's
folder, its scales in `scale.json` (:87-112).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import exact_fp32, resolve_device
from ..ml.nets import ANN
from ..ml.train import apply_in_batches, log_to_dataset
from ..ml.weights import params_from_jax, read_msgpack
from ..utils import xrlite as xr
from .base import Parameterization, register_model, save_model_args, \
    save_variables
from .common import train_regression

__all__ = ["ANNModel", "stencil_stack", "prepare_data_ANN"]

BATCH_SIZE = 2 ** 15


def stencil_stack(q: torch.Tensor, stencil_size: int = 3) -> torch.Tensor:
    """(..., ny, nx) -> (..., ny, nx, stencil_size^2) of circular patches,
    row-major over the (dy, dx) offsets; the centre is at index
    stencil_size^2 // 2."""
    s2 = stencil_size // 2
    return torch.stack([torch.roll(q, (-dy, -dx), dims=(-2, -1))
                        for dy in range(-s2, s2 + 1)
                        for dx in range(-s2, s2 + 1)], dim=-1)


def _flatten_fields(ds: xr.Dataset, key: str) -> np.ndarray:
    """(run,time,lev,y,x) -> (batch, ny, nx) stacking run/time/lev."""
    var = ds[key]
    for d in ("run", "time"):
        if d not in var.dims:
            var = var.expand_dims(d)
    v = var.transpose("run", "time", "lev", "y", "x").values
    return v.reshape(-1, v.shape[-2], v.shape[-1]).astype("float32")


def prepare_data_ANN(ds_list, stencil_size: int, step: int = 3):
    """Multi-dataset stencil training arrays with step-subsampling
    (reference tools/cnn_tools.py:373-396): (X (n, stencil_size^2), Y (n,
    1), x_scale, y_scale), the scales the float64 standard deviations of
    the stencils' centres and of the forcing."""
    if not isinstance(ds_list, (list, tuple)):
        ds_list = [ds_list]
    X, Y = [], []
    for ds in ds_list:
        q = _flatten_fields(ds, "q")
        f = _flatten_fields(ds, "q_forcing_advection")
        st = stencil_stack(torch.from_numpy(q), stencil_size).numpy()
        X.append(st[:, ::step, ::step, :].reshape(-1, stencil_size ** 2))
        Y.append(f[:, ::step, ::step].reshape(-1, 1))
    X = np.concatenate(X)
    Y = np.concatenate(Y)
    center = stencil_size ** 2 // 2
    x_scale = float(X[:, center].astype("float64").std())
    y_scale = float(Y.astype("float64").std())
    return X, Y, x_scale, y_scale


@register_model
class ANNModel(Parameterization):
    def __init__(self, scale_invariant: bool = False, stencil_size: int = 3,
                 hidden_channels=(24, 24), folder: str = "model",
                 read: bool = True, device=None):
        self.device = resolve_device(device)
        self.folder = folder
        self.stencil_size = stencil_size
        self.hidden_channels = tuple(hidden_channels)
        self.scale_invariant = scale_invariant
        self.net = ANN(stencil_size ** 2, 1, self.hidden_channels,
                       degree=2 if scale_invariant else None).to(
            self.device).eval()
        self.variables = None
        if read:
            self.load_model(folder)

    # ------------------------------------------------------------- training
    def fit(self, ds_train, ds_test, num_epochs: int = 50,
            batch_size: int = BATCH_SIZE, learning_rate: float = 1e-3,
            verbose: bool = True, **kw):
        X_train, Y_train, self.x_scale, self.y_scale = \
            prepare_data_ANN(ds_train, self.stencil_size)
        X_test, Y_test, _, _ = prepare_data_ANN(ds_test, self.stencil_size)
        X_train, X_test = X_train / self.x_scale, X_test / self.x_scale
        Y_train, Y_test = Y_train / self.y_scale, Y_test / self.y_scale
        self.variables, log = train_regression(
            self.net, X_train, Y_train, X_test, Y_test,
            num_epochs, min(batch_size, len(X_train)), learning_rate,
            verbose=verbose)
        self.weights_generation += 1
        self.save_model(log)

    def save_model(self, log=None):
        os.makedirs(self.folder, exist_ok=True)
        save_variables(self.variables, f"{self.folder}/net.msgpack")
        with open(f"{self.folder}/scale.json", "w") as f:
            json.dump({"x_scale": self.x_scale, "y_scale": self.y_scale}, f)
        save_model_args("ANNModel", folder=self.folder,
                        stencil_size=self.stencil_size,
                        hidden_channels=list(self.hidden_channels),
                        scale_invariant=self.scale_invariant)
        if log:
            log_to_dataset(log).to_npz(f"{self.folder}/stats.npz")

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/net.msgpack"):
            return False
        self.variables = read_msgpack(f"{folder}/net.msgpack")
        self.net.load_state_dict(params_from_jax(self.variables))
        with open(f"{folder}/scale.json") as f:
            scale = json.load(f)
        self.x_scale = scale["x_scale"]
        self.y_scale = scale["y_scale"]
        self.weights_generation += 1
        return True

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def _field_apply(self, q: torch.Tensor) -> torch.Tensor:
        """(..., ny, nx) -> the same shape, float32."""
        st = stencil_stack(q.to(torch.float32), self.stencil_size)
        with exact_fp32():
            y = self.net(st / self.x_scale)
        return self.y_scale * y.reshape(q.shape)

    def predict_snapshot(self, q, noise=None):
        return self._field_apply(q).to(q.dtype)

    def predict_mean_snapshot(self, q, M: int = 100):
        return self.predict_snapshot(q)

    def predict(self, ds, M: int = 1000) -> xr.Dataset:
        """The prediction of every level field of `ds`, in batches of 256, as
        sample and mean, with zero variance (twin :141-157)."""
        var = ds["q"]
        for d in ("run", "time"):
            if d not in var.dims:
                var = var.expand_dims(d)
        v = var.transpose("run", "time", "lev", "y", "x")
        flat = v.values.reshape(-1, v.shape[-2], v.shape[-1]).astype(
            "float32")
        Y = apply_in_batches(self._field_apply, flat, batch_size=256,
                             device=self.device)
        da = xr.DataArray(Y.reshape(v.shape), dims=v.dims)
        return xr.Dataset({"q_forcing_advection": da,
                           "q_forcing_advection_mean": da,
                           "q_forcing_advection_var": da * 0})
