"""Deterministic CNN regression closure (OLS), online inference.

Twin of the online half of `pyqg_generative_tpu/models/ols_model.py`
(:25-42, :67-92): an AndrewCNN with the options `batch_norm`, `bias`,
`final_activation` and `div`, on the PV normalised by the saved scaler; zero
predicted variance. The twin runs it through XLA with its BatchNorms
unfolded, so the port runs it through cuDNN under `exact_fp32`, online and
in the offline `predict` (twin :93-104). `fit` trains it by MSE regression
on the model's device (`common.train_regression`, checkpointed under
`folder/ckpt`) and `save_model` writes the twin's folder (twin :44-65).
"""
from __future__ import annotations

import os

import torch

from ..device import exact_fp32, resolve_device
from ..ml.nets import AndrewCNN
from ..ml.train import apply_in_batches, log_to_dataset
from ..ml.weights import params_from_jax, read_msgpack
from ..utils import xrlite as xr
from .base import Parameterization, array_to_dataset, extract, \
    prepare_PV_data, register_model, save_model_args, save_variables
from .common import lev_from_nhwc, nhwc_from_lev, read_scalers, \
    set_scalers, train_regression

__all__ = ["OLSModel"]


@register_model
class OLSModel(Parameterization):
    def __init__(self, div: bool = False, batch_norm: bool = True,
                 bias: bool = True, final_activation: str = "None",
                 hidden_channels=(128, 64, 32, 32, 32, 32, 32),
                 folder: str = "model", device=None):
        self.device = resolve_device(device)
        self.folder = folder
        self.div = div
        self.batch_norm = batch_norm
        self.bias = bias
        self.final_activation = final_activation
        self.hidden_channels = tuple(hidden_channels)
        self.net = AndrewCNN(2, 2, hidden_channels=self.hidden_channels,
                             batch_norm=batch_norm, bias=bias,
                             final_activation=final_activation,
                             div=div).to(self.device).eval()
        self.variables = None
        self.load_model(folder)

    # ------------------------------------------------------------- training
    def fit(self, ds_train, ds_test, num_epochs: int = 50,
            batch_size: int = 64, learning_rate: float = 1e-3,
            verbose: bool = True, **kw):
        X_train, Y_train, X_test, Y_test, x_scale, y_scale = \
            prepare_PV_data(ds_train, ds_test)
        set_scalers(self, x_scale, y_scale)
        self.variables, log = train_regression(
            self.net, X_train, Y_train, X_test, Y_test,
            num_epochs, batch_size, learning_rate, verbose=verbose,
            checkpoint_dir=os.path.join(self.folder, "ckpt"))
        self.weights_generation += 1
        self.save_model(log)

    def save_model(self, log=None):
        os.makedirs(self.folder, exist_ok=True)
        save_variables(self.variables, f"{self.folder}/net.msgpack")
        self.x_scale.write("x_scale.json", self.folder)
        self.y_scale.write("y_scale.json", self.folder)
        save_model_args("OLSModel", folder=self.folder, div=self.div,
                        batch_norm=self.batch_norm, bias=self.bias,
                        final_activation=self.final_activation,
                        hidden_channels=list(self.hidden_channels))
        if log:
            log_to_dataset(log).to_npz(f"{self.folder}/stats.npz")

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/net.msgpack"):
            return False
        self.variables = read_msgpack(f"{folder}/net.msgpack")
        self.net.load_state_dict(params_from_jax(self.variables))
        read_scalers(self, folder)
        self.weights_generation += 1
        return True

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def predict_snapshot(self, q, noise=None):
        """q (lev, ny, nx), or the same with a leading member axis -> PV
        forcing shaped like q."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        with exact_fp32():
            y = self.net(x) * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)

    def predict_mean_snapshot(self, q, M: int = 100):
        return self.predict_snapshot(q)

    @torch.no_grad()
    def predict(self, ds, M: int = 1000) -> xr.Dataset:
        """The prediction of each snapshot, in batches of 64, as sample and
        mean, with zero variance (twin :93-104)."""
        X = self.x_scale.normalize(extract(ds, "q"))

        def apply(x):
            with exact_fp32():
                return self.net(x)

        Y = self.y_scale.denormalize(apply_in_batches(apply, X,
                                                      device=self.device))
        da = array_to_dataset(ds, Y, "q_forcing_advection")
        return xr.Dataset({"q_forcing_advection": da,
                           "q_forcing_advection_mean": da,
                           "q_forcing_advection_var": da * 0})
