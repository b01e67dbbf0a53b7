"""Conditional sigma-VAE stochastic closure, online inference.

Twin of `pyqg_generative_tpu/models/cvae_regression.py` (:28-63, :100-136,
:185-221): online, the closure is the decoder, an AndrewCNN on the PV
normalised by the saved scaler plus two channels of latent noise, the same
net as the GAN's generator; with `regression != "None"` a deterministic mean
net (`net_mean.msgpack`, an unfolded AndrewCNN through cuDNN) is added. The
decoder's BatchNorms are folded into the convolutions, and Conv_1..Conv_7 go
through the wrapper of the kernel that `online_variant` names
(`ml/fused_conv.py`; "packed" is K2, the whole ensemble in one launch) in
`inference_dtype`; with `div=True` the chain is 4 wide and its spectral
divergence follows (`ml.nets.divergence_head`), as the twin's "xla" path
applies it. `use_optimal_epoch` switches the decoder to
`decoder_opt.msgpack`, dropping its packed weights. The encoder and training
wait for a later slice.
"""
from __future__ import annotations

import os

import torch

from ..device import exact_fp32, resolve_device
from ..ml.fused_conv import compute_dtype_of
from ..ml.nets import AndrewCNN
from ..ml.weights import params_from_jax, read_msgpack
from .base import Parameterization, register_model
from .cgan_regression import CGANRegression
from .common import lev_from_nhwc, nhwc_from_lev, online_chain, \
    read_scalers

__all__ = ["CVAERegression"]


@register_model
class CVAERegression(Parameterization):
    def __init__(self, regression: str = "None",
                 decoder_var: str | float = "adaptive",
                 folder: str = "model", div: bool = False,
                 hidden_channels=(128, 64, 32, 32, 32, 32, 32),
                 online_variant: str = "dx",
                 inference_dtype: str = "float32", device=None):
        self.compute_dtype = compute_dtype_of(inference_dtype)
        self.device = resolve_device(device)
        self.folder = folder
        self.regression = regression
        self.decoder_var = decoder_var
        self.div = div
        self.hidden_channels = tuple(hidden_channels)
        self.online_variant = online_variant
        self.n_latent = 2
        self.net_mean = AndrewCNN(2, 2, div=div).to(self.device).eval() \
            if regression != "None" else None
        self.vars_dec = None
        self._online_cache = None
        self.load_model(folder)

    def load_model(self, folder) -> bool:
        if not self._load_decoder_file(f"{folder}/decoder.msgpack"):
            return False
        if self.net_mean is not None:
            self.net_mean.load_state_dict(params_from_jax(
                read_msgpack(f"{folder}/net_mean.msgpack")))
        read_scalers(self, folder)
        return True

    def _load_decoder_file(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        self.vars_dec = read_msgpack(path)
        self._online_cache = None
        self.weights_generation += 1
        return True

    def use_optimal_epoch(self) -> bool:
        """Switch the decoder to the best-offline-loss epoch's weights
        (decoder_opt.msgpack), if they were saved."""
        return self._load_decoder_file(f"{self.folder}/decoder_opt.msgpack")

    # ------------------------------------------------------------- inference
    latent_shape = CGANRegression.latent_shape
    generate_latent_noise = CGANRegression.generate_latent_noise

    def _online_dec(self):
        """The online decoder: BN-folded, Conv_0 in PyTorch and
        Conv_1..Conv_7 through a kernel's wrapper, then the divergence head
        if `div`."""
        if self._online_cache is None:
            self._online_cache = online_chain(
                self.vars_dec, self.compute_dtype, self.online_variant,
                self.device, self.div)
        return self._online_cache

    @torch.no_grad()
    def generate(self, x, z):
        """Normalised-space decoding of x, z (B, ny, nx, C) NHWC, plus the
        mean net's prediction where there is one."""
        y = self._online_dec()(torch.cat([x, z], dim=-1))
        if self.net_mean is not None:
            with exact_fp32():
                y = y + self.net_mean(x)
        return y

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
