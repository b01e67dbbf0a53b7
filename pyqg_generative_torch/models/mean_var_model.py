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
sample. `fit` trains the two nets in turn (twin :52-76): the mean net by MSE
regression, then the variance net on the squared residuals of the mean net
in eval mode; `save_model` writes the twin's folder (:78-90).
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
from ..ml.train import apply_in_batches, log_to_dataset
from ..ml.weights import params_from_jax, read_msgpack
from ..utils import xrlite as xr
from .base import Parameterization, array_to_dataset, extract, \
    prepare_PV_data, register_model, save_model_args, save_variables
from .cgan_regression import CGANRegression
from .common import eval_in_batches, lev_from_nhwc, nhwc_from_lev, \
    offline_variant, read_scalers, set_scalers, train_regression

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

    # ------------------------------------------------------------- training
    def fit(self, ds_train, ds_test, num_epochs: int = 50,
            batch_size: int = 64, learning_rate: float = 1e-3,
            verbose: bool = True, **kw):
        X_train, Y_train, X_test, Y_test, x_scale, y_scale = \
            prepare_PV_data(ds_train, ds_test)
        set_scalers(self, x_scale, y_scale)
        self.vars_mean, log_mean = train_regression(
            self.net_mean, X_train, Y_train, X_test, Y_test,
            num_epochs, batch_size, learning_rate, verbose=verbose,
            checkpoint_dir=os.path.join(self.folder, "ckpt_mean"))

        # second stage: the variance net on the squared residuals
        # (reference models/mean_var_model.py:55-64)
        Yhat_train = eval_in_batches(self.net_mean, X_train, self.device)
        Yhat_test = eval_in_batches(self.net_mean, X_test, self.device)
        rsq_train = (Y_train - Yhat_train) ** 2
        rsq_test = (Y_test - Yhat_test) ** 2
        self.vars_var, log_var = train_regression(
            self.net_var, X_train, rsq_train, X_test, rsq_test,
            num_epochs, batch_size, learning_rate, verbose=verbose,
            checkpoint_dir=os.path.join(self.folder, "ckpt_var"))
        self._online_cache = None
        self._offline_cache = None
        self.weights_generation += 1
        self.save_model(log_mean, log_var)

    def save_model(self, log_mean=None, log_var=None):
        os.makedirs(self.folder, exist_ok=True)
        save_variables(self.vars_mean, f"{self.folder}/net_mean.msgpack")
        save_variables(self.vars_var, f"{self.folder}/net_var.msgpack")
        self.x_scale.write("x_scale.json", self.folder)
        self.y_scale.write("y_scale.json", self.folder)
        save_model_args("MeanVarModel", folder=self.folder,
                        hidden_channels=list(self.hidden_channels))
        if log_mean:
            log_to_dataset(log_mean).to_npz(f"{self.folder}/stats_mean.npz")
        if log_var:
            log_to_dataset(log_var).to_npz(f"{self.folder}/stats_var.npz")

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
