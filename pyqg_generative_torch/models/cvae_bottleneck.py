"""Bottleneck conditional VAE closure, online inference.

Twin of the online half of `pyqg_generative_tpu/models/cvae_bottleneck.py`
(:29-55, :99-122, :178-204): the latent is flat, `deep_latent` numbers a
member, so noise is (members, deep_latent) (or (deep_latent,) for one). An
`Upsampling` deep decoder maps it to a 2-channel latent image, which the
AndrewCNN decoder reads beside the PV normalised by the saved scaler; with
`regression != "None"` (the default, "full_loss") a deterministic mean net
is added. The twin runs these nets through XLA with their BatchNorms
unfolded, so the port runs them through cuDNN under `exact_fp32`. With
`div=True` the decoder and mean net end in the divergence head. Offline,
`predict` is the GAN's mean and variance program (twin :140-157) on flat
latents (M, B, deep_latent), all three nets through cuDNN.

Training is the VAE's `train_CVAE` (twin :57-97, :160-178): the
`Downsampling` encoder maps (x, y) to the flat latent's (mu, logvar), the
deep decoder and the decoder map a sample back to the forcing; with
`regression != "None"` the mean net trains first. After every epoch the
three nets' flax trees are rewritten from the trained modules and
`weights_generation` grows.
"""
from __future__ import annotations

import os

import torch

from ..device import exact_fp32, resolve_device
from ..ml.nets import AndrewCNN, Downsampling, Upsampling, init_weights
from ..ml.weights import params_from_jax, params_to_jax, read_msgpack
from .base import Parameterization, register_model, save_model_args, \
    save_variables
from .cgan_regression import CGANRegression, _seed0_draws, loss_to_dataset
from .common import bn_apply, lev_from_nhwc, nhwc_from_lev, read_scalers
from .cvae_regression import CVAERegression

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

        self.hidden_channels = (128, 64, 32, 32, 32, 32, 32)
        self.decoder = net(AndrewCNN(2 + self.n_latent, 2, div=div))
        self.encoder = net(Downsampling(4, 4, 2 * deep_latent, nx=nx))
        self.deep_decoder = net(Upsampling(deep_latent, 4, self.n_latent,
                                           nx=nx))
        self.net_mean = net(AndrewCNN(2, 2, div=div)) \
            if regression != "None" else None
        self.vars_enc = self.vars_deep = self.vars_dec = None
        self.vars_mean = None
        self.load_model(folder)

    # the VAE's fit; its training plumbing below
    fit = CVAERegression.fit

    def save_model(self, log=None):
        os.makedirs(self.folder, exist_ok=True)
        save_variables(self.vars_enc, f"{self.folder}/encoder.msgpack")
        save_variables(self.vars_deep, f"{self.folder}/deep_decoder.msgpack")
        save_variables(self.vars_dec, f"{self.folder}/decoder.msgpack")
        if self.regression != "None":
            save_variables(self.vars_mean, f"{self.folder}/net_mean.msgpack")
        self.x_scale.write("x_scale.json", self.folder)
        self.y_scale.write("y_scale.json", self.folder)
        save_model_args("CVAEBottleneck", folder=self.folder,
                        regression=self.regression, nx=self.nx, div=self.div,
                        decoder_var=self.decoder_var,
                        deep_latent=self.deep_latent)
        if log:
            stats, _ = loss_to_dataset(log)
            stats.to_npz(f"{self.folder}/stats.npz")

    def load_model(self, folder) -> bool:
        """The folder's nets (the encoder where `encoder.msgpack` is there:
        only training reads it) and scalers."""
        if not os.path.exists(f"{folder}/deep_decoder.msgpack"):
            return False
        nets = {"enc": ("encoder", self.encoder),
                "deep": ("deep_decoder", self.deep_decoder),
                "dec": ("decoder", self.decoder),
                "mean": ("net_mean", self.net_mean)}
        for name, (fname, module) in nets.items():
            path = f"{folder}/{fname}.msgpack"
            if module is None or (name == "enc" and not os.path.exists(path)):
                continue
            setattr(self, f"vars_{name}", read_msgpack(path))
            module.load_state_dict(params_from_jax(
                getattr(self, f"vars_{name}")))
        read_scalers(self, folder)
        self.weights_generation += 1
        return True

    # ------------------------------------------------ training plumbing
    def _vae_modules(self) -> dict:
        return {"enc": self.encoder, "deep": self.deep_decoder,
                "dec": self.decoder}

    def _init_vae_variables(self, generator: torch.Generator) -> None:
        """Fresh weights, drawn from `generator`, for the encoder, the deep
        decoder and the decoder in turn, each only where the model has
        none (twin :57-76)."""
        for name, module in self._vae_modules().items():
            if getattr(self, f"vars_{name}") is None:
                init_weights(module, generator)

    def _set_vae_variables(self) -> None:
        """Rewrite the three nets' flax trees from the trained modules."""
        for name, module in self._vae_modules().items():
            module.eval()
            setattr(self, f"vars_{name}", params_to_jax(module.state_dict()))
        self.weights_generation += 1

    def _encode_train(self, x, y, train):
        out = bn_apply(self.encoder, torch.cat([x, y], dim=-1), train)
        return out[:, :self.deep_latent], out[:, self.deep_latent:]

    def _decode_train(self, x, z, train):
        zimg = bn_apply(self.deep_decoder, z, train)
        return bn_apply(self.decoder, torch.cat([x, zimg], dim=-1), train)

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

    # ---------------------------------------------------------------- offline
    @torch.no_grad()
    def _generate_draws(self, x, z):
        """m draws at once: x (B, ny, nx, 2) normalised, z (m, B,
        deep_latent) -> (m, B, ny, nx, 2), the m*B images as one batch."""
        m = z.shape[0]
        with exact_fp32():
            zimg = self.deep_decoder(z.flatten(0, 1))
            xs = x.expand((m,) + tuple(x.shape)).flatten(0, 1)
            y = self.decoder(torch.cat([xs, zimg], dim=-1)).unflatten(
                0, (m, -1))
            if self.net_mean is not None:
                y = y + self.net_mean(x)
        return y

    _mean_var_program = CGANRegression._mean_var_program
    _draws = CGANRegression._draws
    predict = CGANRegression.predict
