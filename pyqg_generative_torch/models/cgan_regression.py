"""Conditional GAN stochastic closure, online inference.

Twin of `pyqg_generative_tpu/models/cgan_regression.py` (:43-95, :135-177,
:274-351): the generator G(q, z) runs on the PV normalised by the saved
scaler, plus two channels of latent noise; with `regression != "None"` a
deterministic mean net is added. The generator is an AndrewCNN or the
DeepInversion U-Net:

* AndrewCNN: online, its BatchNorms are folded into the convolutions, and
  Conv_1..Conv_7 always go through the wrapper of the kernel that
  `online_variant` names (`ml/fused_conv.py`), in `inference_dtype`
  (float32, or bfloat16 with Conv_0 kept in float32): the CUDA kernel for a
  tensor on the card, its plain version for one on the CPU. With `div=True`
  the chain is 4 wide and its spectral divergence (`ml.nets.divergence_head`)
  follows in `torch.fft`, as the twin's default "xla" path applies it (its
  "pallas" path omits it; ROADMAP, queue 3).
* DeepInversion: the twin runs it through XLA with its unfolded BatchNorms
  in float32 (its bf16 `G_online` is never reached: `predict_snapshot` takes
  `G` whenever the online variables are `vars_G`), so the port runs it
  through cuDNN under `exact_fp32`, in float32 whatever `inference_dtype`.

Offline, `predict` gives a sample, the mean and the variance of M draws a
snapshot (twin :353-417) in float32 whatever `inference_dtype`, as the
twin's offline program runs its flax net in float32: an AndrewCNN generator
then runs a float32 chain of its own, BN-folded, through K1 or K2
(`common.offline_variant`), never the bf16 online pack; m draws of a batch
of snapshots go through the chain as one batch of m*B images
(`common.OFFLINE_PIXELS`), and are summed draw by draw as the twin's scan
sums them. The draws are an argument of `_mean_var_program`, since torch
cannot draw the twin's threefry keys.

`use_optimal_epoch` and `use_stable_epoch` switch the generator to
`G_opt.msgpack` or `G_stable.msgpack`: the packed kernel weights, online
and offline, are dropped and `weights_generation` grows, so no graph
captured before the switch replays after it (`sim/graph.py`). The twin's
`online_backend` switch has no counterpart. Training and the critic wait
for later slices.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ..device import exact_fp32, resolve_device
from ..ml.fused_conv import compute_dtype_of
from ..ml.nets import AndrewCNN, DeepInversionGenerator
from ..ml.train import apply_in_batches
from ..ml.weights import params_from_jax, read_msgpack
from ..utils import xrlite as xr
from .base import Parameterization, array_to_dataset, extract, \
    register_model
from .common import draw_chunks, lev_from_nhwc, nhwc_from_lev, \
    offline_variant, online_chain, read_scalers

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
        if generator not in ("Andrew", "DeepInversion"):
            raise ValueError("generator not implemented")
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
        if generator == "Andrew":
            G = AndrewCNN(2 + self.n_latent, 2,
                          hidden_channels=self.hidden_channels, div=div)
        else:
            G = DeepInversionGenerator(2 + self.n_latent, 2)
        self.G = G.to(self.device).eval()
        self.net_mean = AndrewCNN(2, 2, div=div).to(self.device).eval() \
            if regression != "None" else None
        self.vars_G = None
        self._online_cache = None
        self._offline_cache = None
        self.load_model(folder)

    def load_model(self, folder) -> bool:
        if not self._load_generator_file(f"{folder}/G.msgpack"):
            return False
        if self.net_mean is not None:
            self.net_mean.load_state_dict(params_from_jax(
                read_msgpack(f"{folder}/net_mean.msgpack")))
        read_scalers(self, folder)
        return True

    def _load_generator_file(self, path: str) -> bool:
        """Load the generator's weights from `path`, if it exists, dropping
        the packed weights of the old ones."""
        if not os.path.exists(path):
            return False
        self.vars_G = read_msgpack(path)
        self.G.load_state_dict(params_from_jax(self.vars_G))
        self._online_cache = None
        self._offline_cache = None
        self.weights_generation += 1
        return True

    def use_optimal_epoch(self) -> bool:
        """Switch the generator to the best-offline-loss epoch's weights
        (G_opt.msgpack), if they were saved."""
        return self._load_generator_file(f"{self.folder}/G_opt.msgpack")

    def use_stable_epoch(self) -> bool:
        """Switch the generator to the online-stability-selected epoch's
        weights (G_stable.msgpack), if they were saved."""
        return self._load_generator_file(f"{self.folder}/G_stable.msgpack")

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
        """The online generator. AndrewCNN: BN-folded, Conv_0 in PyTorch,
        Conv_1..Conv_7 through a kernel's wrapper, then the divergence head
        if `div`; DeepInversion: the unfolded net in float32."""
        if self._online_cache is None:
            if self.generator != "Andrew":
                def unfolded(x):
                    with exact_fp32():
                        return self.G(x)
                self._online_cache = unfolded
            else:
                self._online_cache = online_chain(
                    self.vars_G, self.compute_dtype, self.online_variant,
                    self.device, self.div)
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

    # ---------------------------------------------------------------- offline
    def _offline_cnn(self):
        """The generator's offline forward, in float32: an AndrewCNN's
        BN-folded chain packed in float32 for the kernel `offline_variant`
        names (a bf16 model's online pack is never reused), the
        DeepInversion U-Net as online."""
        if self._offline_cache is None:
            if self.generator != "Andrew":
                self._offline_cache = self._online_cnn()
            else:
                self._offline_cache = online_chain(
                    self.vars_G, torch.float32,
                    offline_variant(self.online_variant), self.device,
                    self.div)
        return self._offline_cache

    @torch.no_grad()
    def _generate_draws(self, x, z):
        """m draws at once in normalised space: x (B, ny, nx, 2), z (m, B,
        ny, nx, n_latent) -> (m, B, ny, nx, 2); the generator runs the m*B
        images as one batch, the mean net (where there is one) the B."""
        m = z.shape[0]
        xz = torch.cat([x.expand((m,) + tuple(x.shape)), z], dim=-1)
        y = self._offline_cnn()(xz.flatten(0, 1)).unflatten(0, (m, -1))
        if self.net_mean is not None:
            with exact_fp32():
                y = y + self.net_mean(x)
        return y

    def _mean_var_program(self, M: int):
        """(x, draws) -> (sample, mean, var) over M draws: the twin's
        `_mean_var_program` (:364-398) with the draws as an argument. x is
        (B, ny, nx, 2) normalised, `draws` yields chunks (m, B) + latent, M
        draws in all. The sample is the first draw; s and ss sum in float32,
        draw by draw, as the twin's scan; mean = s / M and var = (ss -
        M mean^2) / max(M - 1, 1), the twin's formula."""
        def fn(x, draws):
            first = s = ss = None
            n = 0
            for z in draws:
                y = self._generate_draws(x, z)
                if first is None:
                    first, s, ss = y[0], torch.zeros_like(y[0]), \
                        torch.zeros_like(y[0])
                for yj in y:
                    s += yj
                    ss += yj * yj
                n += y.shape[0]
            if n != M:
                raise ValueError(f"{n} draws given, {M} expected")
            mean = s / M
            var = (ss - M * mean ** 2) / max(M - 1, 1)
            return first, mean, var
        return fn

    def _draws(self, generator, M: int, x):
        """M draws of the latent for the batch x (B, ny, nx, C), in
        chunks."""
        B, ny, nx, _ = x.shape
        return draw_chunks(generator, M, (B,), self.latent_shape(ny, nx),
                           B * ny * nx)

    def predict(self, ds, M: int = 1000, key: int = 0) -> xr.Dataset:
        """A sample, the mean and the variance of M draws for each snapshot
        of `ds`, in batches of 64 snapshots (twin :404-417); the draws come
        from a generator on the model's device seeded with `key`."""
        X = self.x_scale.normalize(extract(ds, "q"))
        fn = self._mean_var_program(M)
        generator = torch.Generator(device=self.device).manual_seed(int(key))
        Y, mean, var = apply_in_batches(
            lambda x: fn(x, self._draws(generator, M, x)), X,
            batch_size=64, device=self.device)
        return xr.Dataset({
            "q_forcing_advection": array_to_dataset(
                ds, self.y_scale.denormalize(Y), "f"),
            "q_forcing_advection_mean": array_to_dataset(
                ds, self.y_scale.denormalize(mean), "m"),
            "q_forcing_advection_var": array_to_dataset(
                ds, self.y_scale.denormalize_var(var), "v")})

    def predict_ensemble(self, ds, M: int = 1000, key: int = 0):
        """M generated forcings of each snapshot, (ens, run, time, lev, y,
        x), in batches of 16 snapshots (twin :419-436). Member e of snapshot
        n is a draw for snapshot n; the twin's reshape mixes snapshots
        (ROADMAP, queue 3)."""
        X = self.x_scale.normalize(extract(ds, "q"))
        generator = torch.Generator(device=self.device).manual_seed(int(key))

        def run(x):
            return torch.cat([self._generate_draws(x, z) for z in
                              self._draws(generator, M, x)]).movedim(0, 1)

        Y = apply_in_batches(run, X, batch_size=16, device=self.device)
        q = ds["q"]
        for d in ("run", "time"):
            if d not in q.dims:
                q = q.expand_dims(d)
        shape = q.transpose("run", "time", "lev", "y", "x").shape
        arr = np.moveaxis(self.y_scale.denormalize(Y), -1, 2)
        arr = arr.reshape((shape[0], shape[1], M) + shape[2:]).transpose(
            2, 0, 1, 3, 4, 5)
        return xr.DataArray(arr, dims=("ens", "run", "time", "lev", "y", "x"))
