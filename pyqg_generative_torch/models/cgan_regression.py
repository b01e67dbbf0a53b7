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

`use_optimal_epoch` and `use_stable_epoch` switch the generator to
`G_opt.msgpack` or `G_stable.msgpack`: the packed kernel weights are dropped
and `weights_generation` grows, so no graph captured before the switch
replays after it (`sim/graph.py`). The twin's `online_backend` switch has no
counterpart. Training and the critic wait for later slices.
"""
from __future__ import annotations

import os
from functools import lru_cache

import torch

from ..device import exact_fp32, resolve_device
from ..ml.fused_conv import compute_dtype_of
from ..ml.nets import AndrewCNN, DeepInversionGenerator
from ..ml.weights import params_from_jax, read_msgpack
from .base import Parameterization, register_model
from .common import lev_from_nhwc, nhwc_from_lev, online_chain, \
    read_scalers

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
