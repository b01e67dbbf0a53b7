"""Deterministic CNN regression closure (OLS), online inference.

Twin of the online half of `pyqg_generative_tpu/models/ols_model.py`
(:25-42, :67-92): an AndrewCNN with the options `batch_norm`, `bias`,
`final_activation` and `div`, on the PV normalised by the saved scaler; zero
predicted variance. The twin runs it through XLA with its BatchNorms
unfolded, so the port runs it through cuDNN under `exact_fp32`. Training
waits for a later slice.
"""
from __future__ import annotations

import os

import torch

from ..device import exact_fp32, resolve_device
from ..ml.nets import AndrewCNN
from ..ml.weights import params_from_jax, read_msgpack
from .base import Parameterization, register_model
from .common import lev_from_nhwc, nhwc_from_lev, read_scalers

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
