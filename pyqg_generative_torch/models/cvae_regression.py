"""Conditional sigma-VAE stochastic closure, online inference.

Twin of `pyqg_generative_tpu/models/cvae_regression.py` (:28-63, :117-136,
:185-221): online, the closure is the decoder, an AndrewCNN on the PV
normalised by the saved scaler plus two channels of latent noise, the same
net as the GAN's generator. Its BatchNorms are folded into the
convolutions, and Conv_1..Conv_7 go through the wrapper of the kernel that
`online_variant` names (`ml/fused_conv.py`; "packed" is K2, the whole
ensemble in one launch) in `inference_dtype`. The encoder and training wait
for a later slice; no shipped model uses `regression` or `div`, which raise.
"""
from __future__ import annotations

import os

import torch

from ..device import resolve_device
from ..ml.fused_conv import compute_dtype_of, make_online_cnn
from ..ml.nets import fold_batchnorm
from ..ml.weights import read_msgpack
from .base import Parameterization, register_model
from .cgan_regression import CGANRegression
from .common import lev_from_nhwc, nhwc_from_lev, read_scalers

__all__ = ["CVAERegression"]


@register_model
class CVAERegression(Parameterization):
    def __init__(self, regression: str = "None",
                 decoder_var: str | float = "adaptive",
                 folder: str = "model", div: bool = False,
                 hidden_channels=(128, 64, 32, 32, 32, 32, 32),
                 online_variant: str = "dx",
                 inference_dtype: str = "float32", device=None):
        if regression != "None" or div:
            raise NotImplementedError("regression and div are not ported "
                                      "yet")
        self.compute_dtype = compute_dtype_of(inference_dtype)
        self.device = resolve_device(device)
        self.folder = folder
        self.regression = regression
        self.decoder_var = decoder_var
        self.div = div
        self.hidden_channels = tuple(hidden_channels)
        self.online_variant = online_variant
        self.n_latent = 2
        self.vars_dec = None
        self._online_cache = None
        self.load_model(folder)

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/decoder.msgpack"):
            return False
        self.vars_dec = read_msgpack(f"{folder}/decoder.msgpack")
        read_scalers(self, folder)
        self._online_cache = None
        return True

    # ------------------------------------------------------------- inference
    latent_shape = CGANRegression.latent_shape
    generate_latent_noise = CGANRegression.generate_latent_noise

    def _online_dec(self):
        """The online decoder: BN-folded, Conv_0 in PyTorch and
        Conv_1..Conv_7 through a kernel's wrapper."""
        if self._online_cache is None:
            self._online_cache = make_online_cnn(
                fold_batchnorm(self.vars_dec), self.compute_dtype,
                variant=self.online_variant, device=self.device)
        return self._online_cache

    @torch.no_grad()
    def generate(self, x, z):
        """Normalised-space decoding of x, z (B, ny, nx, C) NHWC."""
        return self._online_dec()(torch.cat([x, z], dim=-1))

    @torch.no_grad()
    def predict_snapshot(self, q, noise):
        """q (lev, ny, nx) with noise (ny, nx, 2), or the same with a leading
        member axis -> PV forcing shaped like q."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        y = self.generate(x, noise if batched else noise[None]) * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)

    def predict_mean_snapshot(self, q, M: int = 100,
                              generator: torch.Generator | None = None):
        """Ensemble mean of M decoder samples, as the twin shares the GAN's
        (CGANRegression.predict_mean_snapshot)."""
        return CGANRegression.predict_mean_snapshot(self, q, M, generator)
