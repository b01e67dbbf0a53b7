"""Bottleneck conditional VAE closure, online inference.

Twin of the online half of `pyqg_generative_tpu/models/cvae_bottleneck.py`
(:29-55, :99-122, :178-204): the latent is flat, `deep_latent` numbers a
member, so noise is (members, deep_latent) (or (deep_latent,) for one). An
`Upsampling` deep decoder maps it to a 2-channel latent image, which the
AndrewCNN decoder reads beside the PV normalised by the saved scaler; with
`regression != "None"` (the default, "full_loss") a deterministic mean net
is added. The twin runs these nets through XLA with their BatchNorms
unfolded, so the port runs them through cuDNN under `exact_fp32`. With
`div=True` the decoder and mean net end in the divergence head. The
`Downsampling` encoder and training wait for a later slice.
"""
from __future__ import annotations

import os

import torch

from ..device import exact_fp32, resolve_device
from ..ml.nets import AndrewCNN, Upsampling
from ..ml.weights import params_from_jax, read_msgpack
from .base import Parameterization, register_model
from .cgan_regression import CGANRegression, _seed0_draws
from .common import lev_from_nhwc, nhwc_from_lev, read_scalers

__all__ = ["CVAEBottleneck"]


@register_model
class CVAEBottleneck(Parameterization):
    def __init__(self, regression: str = "full_loss", nx: int = 64,
                 decoder_var: str | float = "adaptive",
                 folder: str = "model", div: bool = False,
                 deep_latent: int = 100, device=None):
        self.device = resolve_device(device)
        self.folder = folder
        self.regression = regression
        self.decoder_var = decoder_var
        self.div = div
        self.nx = nx
        self.n_latent = 2
        self.deep_latent = deep_latent

        def net(module):
            return module.to(self.device).eval()

        self.decoder = net(AndrewCNN(2 + self.n_latent, 2, div=div))
        self.deep_decoder = net(Upsampling(deep_latent, 4, self.n_latent,
                                           nx=nx))
        self.net_mean = net(AndrewCNN(2, 2, div=div)) \
            if regression != "None" else None
        self.load_model(folder)

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/deep_decoder.msgpack"):
            return False
        for name, module in (("deep_decoder", self.deep_decoder),
                             ("decoder", self.decoder),
                             ("net_mean", self.net_mean)):
            if module is not None:
                module.load_state_dict(params_from_jax(
                    read_msgpack(f"{folder}/{name}.msgpack")))
        read_scalers(self, folder)
        self.weights_generation += 1
        return True

    # ------------------------------------------------------------- inference
    def latent_shape(self, ny, nx):
        return (self.deep_latent,)

    generate_latent_noise = CGANRegression.generate_latent_noise

    @torch.no_grad()
    def generate(self, x, z):
        """Normalised-space generation: x (B, ny, nx, 2) NHWC, z (B,
        deep_latent) or (deep_latent,)."""
        if z.ndim == 1:
            z = z[None]
        with exact_fp32():
            zimg = self.deep_decoder(z)
            y = self.decoder(torch.cat([x, zimg], dim=-1))
            if self.net_mean is not None:
                y = y + self.net_mean(x)
        return y

    @torch.no_grad()
    def predict_snapshot(self, q, noise):
        """q (lev, ny, nx) with noise (deep_latent,), or the same with a
        leading member axis -> PV forcing shaped like q."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        y = self.generate(x, noise) * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)

    @torch.no_grad()
    def predict_mean_snapshot(self, q, M: int = 100,
                              generator: torch.Generator | None = None):
        """Ensemble mean of M samples of the flat latent (the deterministic
        sampler's closure); without a generator, the M draws of one seeded
        with 0, drawn once (`_seed0_draws`). The twin's inherited method
        draws image-shaped noise, which its deep decoder cannot read."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        shape = (x.shape[0], self.deep_latent)
        if generator is None:
            zs = _seed0_draws(shape, x.device, M)
        else:
            zs = (torch.randn(shape, generator=generator, device=x.device)
                  for _ in range(M))
        total = torch.zeros_like(x)
        for z in zs:
            total = total + self.generate(x, z)
        y = total / M * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)
