"""Conditional GAN stochastic closure, online inference.

Twin of `pyqg_generative_tpu/models/cgan_regression.py` (:43-95, :135-154,
:274-351): the generator G(q, z) is an AndrewCNN on the PV normalised by the
saved scaler, plus two channels of latent noise. Online, its BatchNorms are
folded into the convolutions, and Conv_1..Conv_7 always go through the
wrapper of the kernel that `online_variant` names (`ml/fused_conv.py`), in
`inference_dtype` (float32, or bfloat16 with Conv_0 kept in float32): the
CUDA kernel for a tensor on the card, its plain version for one on the CPU.
The twin's `online_backend` switch has no counterpart. Training, the critic
and the DeepInversion generator wait for later slices.
"""
from __future__ import annotations

import os
from functools import lru_cache

import torch

from ..device import exact_fp32, resolve_device
from ..ml.fused_conv import compute_dtype_of, make_online_cnn
from ..ml.nets import AndrewCNN, fold_batchnorm
from ..ml.weights import params_from_jax, read_msgpack
from .base import Parameterization, register_model
from .common import lev_from_nhwc, nhwc_from_lev, read_scalers

__all__ = ["CGANRegression"]


@lru_cache(maxsize=4)
def _seed0_draws(shape, device, M: int) -> tuple:
    """M standard normal draws of `shape`, in turn, from a generator seeded
    with 0 on `device`."""
    generator = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(shape, generator=generator, device=device)
                 for _ in range(M))


@register_model
class CGANRegression(Parameterization):
    def __init__(self, regression: str = "None", nx: int = 64,
                 generator: str = "Andrew", folder: str = "model",
                 div: bool = False,
                 hidden_channels=(128, 64, 32, 32, 32, 32, 32),
                 inference_dtype: str = "float32",
                 online_variant: str = "dx", device=None):
        if generator != "Andrew":
            raise NotImplementedError(f"generator {generator!r} is not "
                                      "ported yet")
        self.compute_dtype = compute_dtype_of(inference_dtype)
        self.device = resolve_device(device)
        self.folder = folder
        self.online_variant = online_variant
        self.regression = regression
        self.generator = generator
        self.nx = nx
        self.div = div
        self.hidden_channels = tuple(hidden_channels)
        self.n_latent = 2
        self.G = self._net(2 + self.n_latent, batch_norm=True)
        self.net_mean = self._net(2, batch_norm=True) \
            if regression != "None" else None
        self.vars_G = None
        self._online_cache = None
        self.load_model(folder)

    def _net(self, n_in: int, batch_norm: bool) -> AndrewCNN:
        return AndrewCNN(n_in, 2, hidden_channels=self.hidden_channels,
                         batch_norm=batch_norm, div=self.div).to(
            self.device).eval()

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/G.msgpack"):
            return False
        self.vars_G = read_msgpack(f"{folder}/G.msgpack")
        self.G.load_state_dict(params_from_jax(self.vars_G))
        if self.net_mean is not None:
            self.net_mean.load_state_dict(params_from_jax(
                read_msgpack(f"{folder}/net_mean.msgpack")))
        read_scalers(self, folder)
        self._online_cache = None
        return True

    # ------------------------------------------------------------- inference
    def latent_shape(self, ny, nx):
        return (ny, nx, self.n_latent)

    def generate_latent_noise(self, generator, ny, nx, batch_shape=()):
        return torch.randn(tuple(batch_shape) + self.latent_shape(ny, nx),
                           generator=generator, dtype=torch.float32,
                           device=generator.device)

    @torch.no_grad()
    def generate(self, x, z):
        """Normalized-space generation (x, z NHWC), unfolded BatchNorms."""
        with exact_fp32():
            y = self.G(torch.cat([x, z], dim=-1))
            if self.net_mean is not None:
                y = y + self.net_mean(x)
        return y

    def _online_cnn(self):
        """The online generator: BN-folded, Conv_0 in PyTorch and
        Conv_1..Conv_7 through a kernel's wrapper."""
        if self._online_cache is None:
            self._online_cache = make_online_cnn(
                fold_batchnorm(self.vars_G), self.compute_dtype,
                variant=self.online_variant, device=self.device)
        return self._online_cache

    @torch.no_grad()
    def predict_snapshot(self, q, noise):
        """q (lev, ny, nx) with noise (ny, nx, n_latent), or the same with a
        leading member axis -> PV forcing shaped like q."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        xin = torch.cat([x, noise if batched else noise[None]], dim=-1)
        y = self._online_cnn()(xin)
        if self.net_mean is not None:
            with exact_fp32():
                y = y + self.net_mean(x)
        y = y * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)

    @torch.no_grad()
    def predict_mean_snapshot(self, q, M: int = 100,
                              generator: torch.Generator | None = None):
        """Ensemble mean of M generator samples (deterministic sampling).
        Without a generator, the M draws of a generator seeded with 0, the
        same at every call, drawn once (`_seed0_draws`), so that a captured
        step draws nothing."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        shape = x.shape[:-1] + (self.n_latent,)
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
