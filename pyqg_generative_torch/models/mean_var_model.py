"""Guillaumin-Zanna (GZ 2021) mean + variance stochastic closure, online
inference.

Twin of `pyqg_generative_tpu/models/mean_var_model.py` (:25-180): two
AndrewCNNs on the PV normalised by the saved scaler, one for the conditional
mean and one with a softplus head (`VarCNN`) for the pointwise conditional
variance; a sample is mean + sqrt(var) * eps with two channels of latent
noise eps. Online, both nets are BatchNorm-folded and go through a kernel's
wrapper (`ml/fused_conv.py`) in `inference_dtype`; the softplus head is
applied outside the kernel. A variant name ending in "pair" (e.g. "dxbpair")
merges the two nets into one block-diagonal net (`merge_folded_pair`) that
one kernel call runs; otherwise each net is its own call. The twin's
`online_backend` switch has no counterpart. Offline, `predict` (twin
:181-197) runs the two nets in float32, each as a BN-folded chain of its own
through K1 or K2 (`common.offline_variant`), and samples with numpy's
`default_rng(0)` as the twin does, so that both packages draw the same
sample. Training waits for a later slice.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_fp32, resolve_device
from ..ml.fused_conv import compute_dtype_of, make_online_cnn, \
    merge_folded_pair
from ..ml.nets import AndrewCNN, VarCNN, fold_batchnorm
from ..ml.train import apply_in_batches
from ..ml.weights import params_from_jax, read_msgpack
from ..utils import xrlite as xr
from .base import Parameterization, array_to_dataset, extract, \
    register_model
from .cgan_regression import CGANRegression
from .common import lev_from_nhwc, nhwc_from_lev, offline_variant, \
    read_scalers

__all__ = ["MeanVarModel"]


@register_model
class MeanVarModel(Parameterization):
    def __init__(self, hidden_channels=(128, 64, 32, 32, 32, 32, 32),
                 folder: str = "model", online_variant: str = "dx",
                 inference_dtype: str = "float32", device=None):
        self.compute_dtype = compute_dtype_of(inference_dtype)
        self.device = resolve_device(device)
        self.folder = folder
        self.online_variant = online_variant
        self.hidden_channels = tuple(hidden_channels)
        self.net_mean = AndrewCNN(2, 2, hidden_channels=self.hidden_channels
                                  ).to(self.device).eval()
        self.net_var = VarCNN(2, 2, hidden_channels=self.hidden_channels
                              ).to(self.device).eval()
        self.vars_mean = None
        self.vars_var = None
        self._online_cache = None
        self._offline_cache = None
        self.load_model(folder)

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/net_mean.msgpack"):
            return False
        self.vars_mean = read_msgpack(f"{folder}/net_mean.msgpack")
        self.vars_var = read_msgpack(f"{folder}/net_var.msgpack")
        self.net_mean.load_state_dict(params_from_jax(self.vars_mean))
        self.net_var.load_state_dict(params_from_jax(self.vars_var))
        read_scalers(self, folder)
        self._online_cache = None
        self._offline_cache = None
        return True

    # ------------------------------------------------------------- inference
    def latent_shape(self, ny, nx):
        return (ny, nx, 2)

    generate_latent_noise = CGANRegression.generate_latent_noise

    def _online_fns(self):
        """The online forwards: (merged pair,) giving [mean(2) | var
        pre-activation(2)] for a "...pair" variant, else (mean, var
        pre-activation), one folded net each."""
        if self._online_cache is None:
            folded = (fold_batchnorm(self.vars_mean),
                      fold_batchnorm(self.vars_var))
            if self.online_variant.endswith("pair"):
                base = self.online_variant[:-len("pair")] or "dx"
                folded = (merge_folded_pair(*folded),)
            else:
                base = self.online_variant
            self._online_cache = tuple(
                make_online_cnn(f, self.compute_dtype, variant=base,
                                device=self.device) for f in folded)
        return self._online_cache

    @torch.no_grad()
    def predict_snapshot(self, q, noise):
        """q (lev, ny, nx) with noise (ny, nx, 2), or the same with a leading
        member axis -> PV forcing shaped like q."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        fns = self._online_fns()
        y = fns[0](x) if len(fns) == 1 else torch.cat([f(x) for f in fns], -1)
        mean, var_pre = y[..., :2], y[..., 2:]
        y = mean + (noise if batched else noise[None]) * torch.sqrt(
            F.softplus(var_pre))
        y = y * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)

    @torch.no_grad()
    def predict_mean_snapshot(self, q, M: int = 100):
        """The conditional mean (the deterministic sampler's closure), from
        the unfolded mean net."""
        batched = q.ndim == 4
        x = nhwc_from_lev(q).to(torch.float32) / self._x_std
        with exact_fp32():
            y = self.net_mean(x) * self._y_std
        return lev_from_nhwc(y, batched=batched).to(q.dtype)

    # ---------------------------------------------------------------- offline
    def _offline_fns(self):
        """(mean, variance pre-activation): each net BN-folded and packed in
        float32 for the kernel `offline_variant` names."""
        if self._offline_cache is None:
            variant = offline_variant(self.online_variant)
            self._offline_cache = tuple(
                make_online_cnn(fold_batchnorm(v), torch.float32,
                                variant=variant, device=self.device)
                for v in (self.vars_mean, self.vars_var))
        return self._offline_cache

    @torch.no_grad()
    def predict(self, ds, M: int = 1000) -> xr.Dataset:
        """The conditional mean and variance of each snapshot, in batches of
        64, and a sample mean + sqrt(var) eps with eps from numpy's
        `default_rng(0)` (twin :181-197)."""
        X = self.x_scale.normalize(extract(ds, "q"))
        f_mean, f_var = self._offline_fns()
        mean = self.y_scale.denormalize(apply_in_batches(
            f_mean, X, device=self.device))
        var = self.y_scale.denormalize_var(apply_in_batches(
            lambda x: F.softplus(f_var(x)), X, device=self.device))
        rng = np.random.default_rng(0)
        Y = mean + np.sqrt(var) * rng.standard_normal(var.shape).astype(
            "float32")
        return xr.Dataset({
            "q_forcing_advection": array_to_dataset(ds, Y,
                                                    "q_forcing_advection"),
            "q_forcing_advection_mean": array_to_dataset(ds, mean, "m"),
            "q_forcing_advection_var": array_to_dataset(ds, var, "v")})
