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
`online_backend` switch has no counterpart.

Training (twin :98-133, :179-272, :446-713): `fit` trains the critic
`DCGANDiscriminator` and the generator by `train_CGAN`, one
`make_gan_batch_step` a batch on device-resident data, under
`exact_fp32_training` (PyTorch's own float32 convolutions, deterministic, the
gradient penalty's double backward included: cuDNN's deterministic weight
gradients of the 5x5 convs lose float32's precision). The draws the twin splits
from its key (z1, z2, the penalty's eps and swap) come from a torch.Generator
seeded with `key` (`gan_draws`), and the batch step takes them as an argument.
On CUDA data `GanTrainer.step` runs the batch (its rows, draws and step) as a
CUDA graph per branch, critic-only or critic and generator
(`ml/train_graph.py`), as `VaeTrainer.step` runs the VAE's. After every
epoch the flax tree `vars_G` is rewritten from the trained generator and
`weights_generation` grows, so the offline evaluation and any graph run on
the new weights. The best epoch by offline loss is kept in
`G_opt.msgpack`, every `retain_every`-th epoch in `epoch_bank/`, from which
`select_stable_epoch` picks by short online rollouts.
"""
from __future__ import annotations

import glob
import os
import time
from functools import lru_cache

import numpy as np
import torch

from ..device import exact_fp32, exact_fp32_training, resolve_device
from ..eval.metrics import subgrid_scores
from ..ml.fused_conv import compute_dtype_of
from ..ml.nets import AndrewCNN, DCGANDiscriminator, DeepInversionGenerator, \
    init_weights
from ..ml.train import Adam, TrainCheckpointer, apply_in_batches, \
    epoch_permutation, log_to_dataset, mean_metrics, named_params, \
    piecewise_constant_schedule
from ..ml.train_graph import COUNTERS, GraphedTrainStep
from ..ml.weights import params_from_jax, params_to_jax, read_msgpack
from ..utils import xrlite as xr
from ..utils.profiling import count, span
from .base import Parameterization, array_to_dataset, extract, \
    prepare_PV_data, register_model, save_model_args, save_variables
from .common import bn_apply, draw_chunks, eval_in_batches, lev_from_nhwc, \
    nhwc_from_lev, offline_variant, online_chain, read_scalers, \
    set_scalers, train_regression

__all__ = ["CGANRegression", "evaluate_prediction", "loss_to_dataset",
           "gan_draws", "gan_optimizers", "gradient_penalty",
           "make_gan_batch_step", "GENERATOR_STEPS",
           "GenerativeTrainer", "GanTrainer", "SingleCheckpointer",
           "device_data", "run_epochs", "train_CGAN"]

LAMBDA_DRIFT = 1e-3
LAMBDA_GP = 10.0
# the host counter of the training steps that updated the generator too
GENERATOR_STEPS = "train.generator_steps"
count(GENERATOR_STEPS, 0)


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
        self.D = DCGANDiscriminator(6, nx=nx).to(self.device).eval()
        self.net_mean = AndrewCNN(2, 2, div=div).to(self.device).eval() \
            if regression != "None" else None
        self.vars_G = None
        self.vars_D = None
        self.vars_mean = None
        self._online_cache = None
        self._offline_cache = None
        self.load_model(folder)

    # --------------------------------------------------------------- fitting
    def fit(self, ds_train, ds_test, num_epochs: int = 200,
            num_epochs_regression: int = 50, batch_size: int = 64,
            learning_rate: float = 2e-4, nruns: int = 5,
            verbose: bool = True, key: int = 0,
            checkpoint_every: int = 25, retain_every: int = 0):
        X_train, Y_train, X_test, Y_test, x_scale, y_scale = \
            prepare_PV_data(ds_train, ds_test)
        set_scalers(self, x_scale, y_scale)
        if self.regression != "None" and self.vars_mean is None:
            self.vars_mean, _ = train_regression(
                self.net_mean, X_train, Y_train, X_test, Y_test,
                num_epochs_regression, batch_size, 1e-3, verbose=verbose)
        log = train_CGAN(self, ds_train, ds_test, X_train, Y_train,
                         num_epochs, batch_size, learning_rate, nruns,
                         verbose=verbose, key=key,
                         checkpoint_every=checkpoint_every,
                         retain_every=retain_every)
        self.save_model(log)

    def save_model(self, log=None):
        os.makedirs(self.folder, exist_ok=True)
        save_variables(self.vars_G, f"{self.folder}/G.msgpack")
        save_variables(self.vars_D, f"{self.folder}/D.msgpack")
        if self.regression != "None":
            save_variables(self.vars_mean, f"{self.folder}/net_mean.msgpack")
        self.x_scale.write("x_scale.json", self.folder)
        self.y_scale.write("y_scale.json", self.folder)
        save_model_args("CGANRegression", folder=self.folder,
                        regression=self.regression, nx=self.nx,
                        generator=self.generator, div=self.div,
                        hidden_channels=list(self.hidden_channels))
        if log:
            stats, epoch = loss_to_dataset(log)
            stats.to_npz(f"{self.folder}/stats.npz")
            print("Optimal epoch is", epoch)

    def load_model(self, folder) -> bool:
        """The folder's generator, critic (where `D.msgpack` is there: only
        training reads it), mean net and scalers."""
        if not self._load_generator_file(f"{folder}/G.msgpack"):
            return False
        if os.path.exists(f"{folder}/D.msgpack"):
            self.vars_D = read_msgpack(f"{folder}/D.msgpack")
            self.D.load_state_dict(params_from_jax(self.vars_D))
        if self.net_mean is not None:
            self.vars_mean = read_msgpack(f"{folder}/net_mean.msgpack")
            self.net_mean.load_state_dict(params_from_jax(self.vars_mean))
        read_scalers(self, folder)
        return True

    def _load_generator_file(self, path: str) -> bool:
        """Load the generator's weights from `path`, if it exists, dropping
        the packed weights of the old ones."""
        if not os.path.exists(path):
            return False
        self._set_generator(read_msgpack(path))
        return True

    def _set_generator(self, variables: dict) -> None:
        """Switch the generator to the flax tree `variables`."""
        self.G.load_state_dict(params_from_jax(variables))
        self._generator_changed(variables)

    def _generator_changed(self, variables: dict | None = None) -> None:
        """The generator module holds new weights (`variables`, or its own
        trained ones): rewrite `vars_G`, drop the packed weights, online and
        offline, and count a new generation."""
        self.G.eval()
        self.vars_G = variables if variables is not None \
            else params_to_jax(self.G.state_dict())
        self._online_cache = None
        self._offline_cache = None
        self.weights_generation += 1

    def use_optimal_epoch(self) -> bool:
        """Switch the generator to the best-offline-loss epoch's weights
        (G_opt.msgpack), if they were saved."""
        return self._load_generator_file(f"{self.folder}/G_opt.msgpack")

    def use_stable_epoch(self) -> bool:
        """Switch the generator to the online-stability-selected epoch's
        weights (G_stable.msgpack), if they were saved."""
        return self._load_generator_file(f"{self.folder}/G_stable.msgpack")

    def select_stable_epoch(self, pyqg_params=None, q_init=None,
                            years: float = 3.0, n_ens: int = 2,
                            target_std: float | None = None,
                            target_kespec=None, spectrum_weight: float = 1.0,
                            verbose: bool = True):
        """Online-stability-aware epoch selection (twin :179-272): each
        banked generator (epoch_bank/G_*.msgpack, from fit(retain_every=...))
        runs a short online ensemble through `run_ensemble` (graphed on a
        card; each switch raises `weights_generation`, so its graphs are
        captured anew) from `q_init`, and the one whose final std(q) stays
        closest to `target_std` in log (plus `spectrum_weight` x the
        normalised KE-spectrum RMSE against `target_kespec`, over the
        rollout's second half, where given) is saved as G_stable.msgpack
        and loaded. Returns (best_epoch, {epoch: (std, spec_err)})."""
        from ..eval.comparison import _spectral_rmse
        from ..qg.params import ANDREW_1000_STEPS, YEAR, QGParams
        from ..sim import run_ensemble

        bank = sorted(glob.glob(f"{self.folder}/epoch_bank/G_*.msgpack"),
                      key=lambda f: int(f.split("_")[-1].split(".")[0]))
        if not bank:
            return None, {}
        p = pyqg_params or QGParams(nx=self.nx, dt=7200.0,
                                    precision="single")
        tave_frac = 0.5 if target_kespec is not None else 1.0
        p = p.replace(tmax=years * YEAR, tavestart=tave_frac * years * YEAR)
        if q_init is None:
            q_init = np.load(os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))), "tests", "data",
                "eddy48_snapshot.npz"))["q"]
        if target_std is None:
            target_std = float(np.std(q_init))
        orig = self.vars_G
        results = {}
        best = (None, np.inf, None)
        for f in bank:
            epoch = int(f.split("_")[-1].split(".")[0])
            self._load_generator_file(f)
            ds = run_ensemble(p, {"self": self, "sampling": "constant",
                                  "nsteps": 1}, n_ens=n_ens, q_init=q_init,
                              sampling_freq=ANDREW_1000_STEPS, key=epoch,
                              device=self.device)
            std = float(np.std(ds["q"].values[:, -1]))
            spec_err = 0.0
            if target_kespec is not None and "KEspec" not in ds:
                import warnings
                warnings.warn(
                    "select_stable_epoch: target_kespec given but the probe "
                    "run has no KEspec (with_diags off?) — the spectrum "
                    "term drops out and selection degrades to "
                    "amplitude-only", stacklevel=2)
            if target_kespec is not None and "KEspec" in ds:
                probe_spec = ds["KEspec"].values
                if probe_spec.ndim == 4:  # (run, lev, l, k)
                    probe_spec = probe_spec.mean(axis=0)
                diff, scale = _spectral_rmse(probe_spec,
                                             np.asarray(target_kespec))
                spec_err = float(diff / scale)
            results[epoch] = (std, spec_err)
            score = abs(np.log(std / target_std)) + \
                spectrum_weight * spec_err
            if verbose:
                print(f"epoch {epoch}: final std(q) {std:.3e} "
                      f"(target {target_std:.3e})"
                      + (f", KEspec err {spec_err:.3f}"
                         if target_kespec is not None else ""))
            if score < best[1]:
                best = (epoch, score, self.vars_G)
        if best[0] is not None:
            save_variables(best[2], f"{self.folder}/G_stable.msgpack")
        self._set_generator(best[2] if best[0] is not None else orig)
        return best[0], results

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


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def evaluate_prediction(net, ds, nruns=None, M: int = 16, key: int = 0):
    """Subgrid scores on a run subsample (reference cgan_regression.py:224-234)."""
    nrun = ds["q"].sizes()["run"] if "run" in ds["q"].dims else 1
    idx = np.arange(nrun)
    if nruns is not None and nruns < len(idx):
        idx = np.random.default_rng(key).choice(idx, nruns, replace=False)
    sub = ds.isel(run=idx)
    preds = net.predict(sub, M=M)
    s = subgrid_scores(sub["q_forcing_advection"],
                       preds["q_forcing_advection_mean"],
                       preds["q_forcing_advection"])
    return {k: float(np.mean(s[k].values))
            for k in ("L2_mean", "L2_total", "L2_residual")} | \
        {"var_ratio": float(np.mean(s["var_ratio"].values))}


def loss_to_dataset(log: dict):
    """Training curves + optimal-epoch tracking
    (reference cgan_regression.py:236-245)."""
    ds = log_to_dataset(log)
    if "L2_total_test" in log and "L2_residual_test" in log:
        loss = np.asarray(log["L2_total_test"]) + \
            np.asarray(log["L2_residual_test"])
        ds["loss_opt"] = xr.DataArray(loss, ("epoch",))
        epoch_opt = int(np.argmin(loss)) + 1
        ds["Epoch_opt"] = xr.DataArray(np.asarray(epoch_opt))
        return ds, epoch_opt
    return ds, len(next(iter(log.values()), []))


def gan_draws(generator: torch.Generator, x: torch.Tensor, n_latent: int):
    """A batch step's draws, in this order, from `generator` on its device:
    the latents z1 and z2, N(0, 1) of x's shape with n_latent channels; the
    gradient penalty's interpolation weights eps, U[0, 1) a sample; swap,
    a bool that is true with probability 1/2 (where the twin splits its
    key into kz1, kz2, keps and kswap, :497-503)."""
    shape = x.shape[:-1] + (n_latent,)
    kw = {"generator": generator, "device": generator.device,
          "dtype": x.dtype}
    z1 = torch.randn(shape, **kw)
    z2 = torch.randn(shape, **kw)
    eps = torch.rand((x.shape[0], 1, 1, 1), **kw)
    swap = torch.rand((), **kw) < 0.5
    return z1, z2, eps, swap


def gradient_penalty(D, x, ytrue_cat, yfake_cat, eps):
    """The critic's gradient penalty LAMBDA_GP (|dD/dy| - 1)^2, the batch's
    mean, at y = eps ytrue + (1 - eps) yfake: the input gradient is taken
    with `create_graph=True`, so that the penalty's gradient in the critic's
    weights is a double backward through its convolutions. Inside the span
    `train.penalty`."""
    with span("train.penalty"):
        yinterp = (eps * ytrue_cat + (1 - eps) * yfake_cat
                   ).requires_grad_(True)
        dDdy, = torch.autograd.grad(D(torch.cat([x, yinterp], -1)).sum(),
                                    yinterp, create_graph=True)
        norms = torch.sqrt(
            (dDdy.reshape(dDdy.shape[0], -1) ** 2).sum(-1) + 1e-12)
        return LAMBDA_GP * ((norms - 1.0) ** 2).mean()


def make_gan_batch_step(net: CGANRegression, txG: Adam, txD: Adam):
    """One full GAN training step (twin :476-572) on the modules net.G and
    net.D in place: batch_step(opt, batch, gen_step, draws, scalars=None,
    grads=None) -> metrics.

    opt = {"G": G's optimizer state, "D": D's}; batch = (x, y, ymean) NHWC;
    gen_step, a host decision: whether the generator updates too (the
    twin's i % 5 == 0, i the batch's index in its epoch); draws = (z1, z2,
    eps, swap) (`gan_draws`). With scalars = {"D": ..., "G": ...}, each
    optimizer's `Adam.scalars` as written for its count, the step reads no
    host value and leaves both counts to the caller (the form that
    `GanTrainer` captures, a CUDA graph a branch); without, each optimizer
    writes its own and advances its count. G runs in train mode twice
    before the critic update and, on a G step, twice more inside it, so its
    BatchNorm statistics move 2 or 4 times a batch, in the twin's order.
    The critic runs in eval mode; its loss is -0.5 (D(x,y,ŷ2) + D(x,ŷ1,y))
    + D(x,ŷ1,ŷ2) plus the drift LAMBDA_DRIFT D(x,y,ŷ2)^2 and the gradient
    penalty (`gradient_penalty`) at eps true + (1-eps) fake, the true pair
    (ŷ1, y) where swap, else (y, ŷ2). The generator's update reads the
    updated critic; its loss is logged in float32, as the twin logs it.
    With `grads` (a dict), the critic's and generator's gradients are left
    in grads["D"] and grads["G"] by parameter name."""
    G, D = net.G, net.D
    pG, pD = named_params(G), named_params(D)

    def g_forward(x, z):
        return bn_apply(G, torch.cat([x, z], dim=-1), True)

    def batch_step(opt, batch, gen_step, draws, scalars=None, grads=None):
        x, y, ymean = batch
        z1, z2, eps, swap = draws
        # Adam's scalars, where given, as each optimizer's last argument
        given = {k: () if scalars is None else (scalars[k],) for k in "DG"}
        if net.regression == "residual_loss":
            y = y - ymean
        D.eval()
        with exact_fp32_training():
            with span("train.critic"):
                with torch.no_grad():
                    yf1 = g_forward(x, z1)
                    yf2 = g_forward(x, z2)
                    if net.regression == "full_loss":
                        yf1 = yf1 + ymean
                        yf2 = yf2 + ymean

                # ---------------- critic update --------------------------
                Dtrue1 = D(torch.cat([x, y, yf2], -1))
                Dtrue2 = D(torch.cat([x, yf1, y], -1))
                Dfake = D(torch.cat([x, yf1, yf2], -1))
                D_loss = -0.5 * (Dtrue1.mean() + Dtrue2.mean()) + Dfake.mean()
                D_drift = LAMBDA_DRIFT * (Dtrue1 ** 2).mean()
                ytrue_cat = torch.where(swap, torch.cat([yf1, y], -1),
                                        torch.cat([y, yf2], -1))
                yfake_cat = torch.cat([yf1, yf2], -1)
                D_grad = gradient_penalty(D, x, ytrue_cat, yfake_cat, eps)
                gD = torch.autograd.grad(D_loss + D_grad + D_drift,
                                         list(pD.values()))
                txD.step(pD, gD, opt["D"], *given["D"])

            # ---------------- generator update (every 5th batch) ----------
            if gen_step:
                with span("train.generator"):
                    yg1 = g_forward(x, z1)
                    yg2 = g_forward(x, z2)
                    if net.regression == "full_loss":
                        yg1 = yg1 + ymean
                        yg2 = yg2 + ymean
                    G_loss = -D(torch.cat([x, yg1, yg2], -1)).mean()
                    gG = torch.autograd.grad(G_loss, list(pG.values()))
                    txG.step(pG, gG, opt["G"], *given["G"])
                    G_loss = G_loss.detach().to(torch.float32)
            else:
                gG = None
                G_loss = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
        if grads is not None:
            grads["D"] = dict(zip(pD, gD))
            grads["G"] = None if gG is None else dict(zip(pG, gG))
        return {"D_loss": D_loss.detach(), "D_grad": D_grad.detach(),
                "D_drift": D_drift.detach(), "G_loss": G_loss}

    return batch_step


def gan_optimizers(learning_rate: float, num_epochs: int, steps: int):
    """(txG, txD): Adam(b1 0.5, b2 0.999), the rate halved at 1/2, 3/4 and
    7/8 of the epochs' batches, each read at its optimizer's own update
    count (twin :600-604)."""
    sched = [int(num_epochs * f) * steps for f in (0.5, 0.75, 0.875)]
    lr_sched = piecewise_constant_schedule(learning_rate,
                                           {b: 0.5 for b in sched})
    return Adam(lr_sched, b1=0.5, b2=0.999), Adam(lr_sched, b1=0.5,
                                                  b2=0.999)


class GenerativeTrainer:
    """One replica's training (`train_CGAN`, `train_CVAE`, and each replica
    of `ml.multifit`): the model, numpy's default_rng(key), which shuffles,
    and a torch.Generator seeded with `key` on the model's device, which
    draws the fresh weights and every batch's draws; the optimizers' state,
    the log and the best epoch by offline loss, whose weights go to
    `best_file`. A subclass supplies `step`, `trained`, `carry`, `load`,
    `best_vars` and `describe`."""

    best_file = ""

    def __init__(self, net, key: int, n: int, batch_size: int):
        self.net = net
        self.rng = np.random.default_rng(key)
        self.generator = torch.Generator(device=net.device).manual_seed(
            int(key))
        self.n, self.batch_size = n, batch_size
        self.log: dict = {}
        self.best = {"loss": float("inf"), "vars": None, "epoch": 0}

    def batches(self) -> torch.Tensor:
        """This epoch's shuffled batches, (steps, batch_size) indices."""
        return torch.as_tensor(
            epoch_permutation(self.rng, self.n, self.batch_size),
            device=self.net.device)

    def end_epoch(self, epoch: int, rows: list, ds_train, ds_test,
                  nruns, retain_every: int = 0) -> dict:
        """The epoch's row of the log: the batches' mean metrics and, with
        `nruns`, the offline scores on both datasets; the best epoch by
        offline loss is kept beside the last (the reference logs Epoch_opt
        but keeps only the last)."""
        self.trained()
        row = mean_metrics(rows)
        if nruns:
            row.update(evaluate_prediction(self.net, ds_train, nruns,
                                           key=epoch))
            row.update({f"{k}_test": v for k, v in evaluate_prediction(
                self.net, ds_test, nruns, key=epoch).items()})
            opt_loss = row.get("L2_total_test", np.inf) + \
                row.get("L2_residual_test", np.inf)
            if opt_loss < self.best["loss"]:
                self.best.update(loss=opt_loss, epoch=epoch + 1,
                                 vars=self.best_vars())
        if retain_every and (epoch + 1) % retain_every == 0:
            bank = os.path.join(self.net.folder, "epoch_bank")
            os.makedirs(bank, exist_ok=True)
            save_variables(self.best_vars(),
                           os.path.join(bank, f"G_{epoch + 1}.msgpack"))
        for k, v in row.items():
            self.log.setdefault(k, []).append(v)
        return row

    def checkpoint(self) -> dict:
        """The carry with the best weights so far (or a template)."""
        return self.carry() | {"best": self.best["vars"]
                               if self.best["vars"] is not None
                               else self.best_template}

    def extra(self) -> dict:
        return {"best_loss": self.best["loss"] if self.best["epoch"]
                else 0.0, "best_epoch": self.best["epoch"]}

    def restore(self, saved: dict, extra: dict) -> None:
        """Resume from a checkpoint's carry and its extra."""
        self.load(saved)
        if extra.get("best_epoch", 0) > 0:
            self.best = {"loss": extra["best_loss"], "vars": saved["best"],
                         "epoch": extra["best_epoch"]}
        self.trained()

    def finish(self) -> None:
        if self.best["vars"] is not None:
            os.makedirs(self.net.folder, exist_ok=True)
            save_variables(self.best["vars"],
                           f"{self.net.folder}/{self.best_file}")


class GanTrainer(GenerativeTrainer):
    """The GAN's replica (twin :575-713): Adam on `gan_optimizers`'
    schedule, fresh weights for G and then D where the model has none, one
    `make_gan_batch_step` a batch on the device-resident `data` (X, Y, the
    mean net's Y), its draws (`gan_draws`) from the replica's generator. A
    step writes the critic's Adam scalars and, on a generator batch (i % 5
    == 0), the generator's, runs `body` (the rows' gather, the draws and
    the batch step) through `GraphedTrainStep` on CUDA data, keyed by the
    branch, or eagerly, counting `train.eager_steps`, on the CPU; then it
    advances the critic's count and, on a generator batch, the generator's,
    counting `train.generator_steps`. The parameters, BatchNorm statistics
    and both Adams' moments are never replaced (`load` copies into them),
    since a graph holds their addresses."""

    best_file = "G_opt.msgpack"

    def __init__(self, net: CGANRegression, data: tuple, num_epochs: int,
                 batch_size: int, learning_rate: float, key: int = 0):
        super().__init__(net, key, len(data[0]), batch_size)
        steps = int(np.ceil(self.n / batch_size))
        self.txG, self.txD = gan_optimizers(learning_rate, num_epochs, steps)
        if net.vars_G is None:
            init_weights(net.G, self.generator)
            net._generator_changed()
        if net.vars_D is None:
            init_weights(net.D, self.generator)
        self.opt = {"G": self.txG.init(named_params(net.G)),
                    "D": self.txD.init(named_params(net.D))}
        # Adam's scalars are kept for the parameters' device and dtype
        self._like = next(net.D.parameters())
        self.best_template = params_to_jax(net.G.state_dict())
        # the body holds the trainer's parts and not the trainer, so that
        # dropping the trainer frees its graphs and pool at once
        txG, txD, opt = self.txG, self.txD, self.opt
        batch_step = make_gan_batch_step(net, txG, txD)
        generator, like, n_latent = self.generator, self._like, net.n_latent

        def body(idx, gen_step):
            with span("train.batch"):  # the rows idx of X, Y, ymean
                batch = tuple(t[idx] for t in data)
                draws = gan_draws(generator, batch[0], n_latent)
            return batch_step(opt, batch, gen_step, draws,
                              {"D": txD.scalars(like), "G": txG.scalars(like)})
        self.body = body
        self.graphed = GraphedTrainStep(body, (generator,)) \
            if data[0].is_cuda else None

    def step(self, i: int, idx: torch.Tensor) -> dict:
        gen_step = i % 5 == 0
        with span("train.step"):
            self.txD.scalars(self._like, self.opt["D"]["count"])
            if gen_step:
                self.txG.scalars(self._like, self.opt["G"]["count"])
            if self.graphed is None:
                count(COUNTERS["eager_steps"])
                metrics = self.body(idx, gen_step)
            else:
                metrics = self.graphed(idx, host=(gen_step,))
            self.opt["D"]["count"] += 1
            if gen_step:
                self.opt["G"]["count"] += 1
                count(GENERATOR_STEPS)
            return metrics

    def trained(self) -> None:
        self.net._generator_changed()
        self.net.vars_D = params_to_jax(self.net.D.state_dict())

    def best_vars(self) -> dict:
        return self.net.vars_G

    def carry(self) -> dict:
        return {"G": self.net.G.state_dict(), "D": self.net.D.state_dict(),
                "optG": self.opt["G"], "optD": self.opt["D"]}

    def load(self, saved: dict) -> None:
        """The saved modules and both Adams' states, copied into the
        trainer's own tensors."""
        self.net.G.load_state_dict(saved["G"])
        self.net.D.load_state_dict(saved["D"])
        with torch.no_grad():
            for net in ("G", "D"):
                state, kept = self.opt[net], saved[f"opt{net}"]
                for part in ("mu", "nu"):
                    for name, t in state[part].items():
                        t.copy_(kept[part][name])
                state["count"] = int(kept["count"])

    def describe(self, row: dict) -> str:
        return (f"D_loss: {row['D_loss']:.3f} G_loss: {row['G_loss']:.3f}"
                + (f" L2_total: {row['L2_total_test']:.3f}"
                   if "L2_total_test" in row else ""))


def device_data(net, X_train, Y_train) -> tuple:
    """(X, Y, the mean net's prediction of Y, or zeros) on the model's
    device."""
    Y_mean = eval_in_batches(net.net_mean, X_train, net.device) \
        if net.regression != "None" else np.zeros_like(Y_train)
    return tuple(torch.as_tensor(a, device=net.device)
                 for a in (X_train, Y_train, Y_mean))


class SingleCheckpointer:
    """`run_epochs`' checkpoint of one replica: `ml.train.TrainCheckpointer`
    over its carry, shuffle stream, draw stream, log and best epoch."""

    def __init__(self, folder: str, every: int, name: str):
        self.ckpt = TrainCheckpointer(folder, every, name=name)

    def restore(self, trainers) -> int:
        t, = trainers
        resumed = self.ckpt.restore(t.checkpoint(), t.generator)
        if resumed is None:
            return 0
        epoch0, saved, t.log, t.rng, t.generator, extra = resumed
        t.restore(saved, extra)
        return epoch0

    def maybe_save(self, epoch: int, trainers) -> None:
        t, = trainers
        self.ckpt.maybe_save(epoch, t.checkpoint(), t.log, t.rng,
                             t.generator, extra=t.extra())

    def clear(self) -> None:
        self.ckpt.clear()


def run_epochs(trainers, ds_trains, ds_tests, num_epochs: int, nruns,
               ckpt, verbose: bool = True, retain_every: int = 0,
               what: str = "GAN") -> None:
    """The epoch loop of one or more replicas, resumed from `ckpt` where it
    holds a checkpoint: the replicas take each batch in turn, in lockstep,
    each on its own batches and draws, then each ends its epoch; `ckpt`
    saves every replica after each epoch (where its `every` says), and the
    best epoch of each is written at the end."""
    epoch0 = ckpt.restore(trainers)
    if epoch0 and verbose:
        print(f"resuming {what} training from epoch {epoch0}")
    t_s = time.time()
    for epoch in range(epoch0, num_epochs):
        t_e = time.time()
        perms = [t.batches() for t in trainers]
        rows = [[] for _ in trainers]
        for i in range(len(perms[0])):
            for t, perm, r in zip(trainers, perms, rows):
                r.append(t.step(i, perm[i]))
        ends = [t.end_epoch(epoch, r, dtr, dte, nruns, retain_every)
                for t, r, dtr, dte in zip(trainers, rows, ds_trains,
                                          ds_tests)]
        ckpt.maybe_save(epoch + 1, trainers)
        if verbose:
            t = time.time()
            eta = (t - t_s) * (num_epochs / (epoch + 1) - 1)
            print(f"[{epoch + 1}/{num_epochs}] [{t - t_e:.2f}/{eta:.2f}] "
                  + " | ".join(tr.describe(row)
                               for tr, row in zip(trainers, ends)))
    ckpt.clear()
    for t in trainers:
        t.finish()


def train_CGAN(net: CGANRegression, ds_train, ds_test, X_train, Y_train,
               num_epochs: int, batch_size: int, learning_rate: float,
               nruns=5, verbose=True, key: int = 0,
               checkpoint_every: int = 25, retain_every: int = 0):
    """The GAN's training loop (twin :575-713), one `GanTrainer`. Every
    `checkpoint_every` epochs the carry (G and D with their optimizer
    states, and the best generator so far) is checkpointed to
    `gan_train_ckpt.npz`, from which a restarted run resumes bit for bit.
    retain_every > 0 banks the generator every `retain_every` epochs to
    `epoch_bank/G_<epoch>.msgpack`; the best generator by offline loss goes
    to `G_opt.msgpack`. Returns the log."""
    trainer = GanTrainer(net, device_data(net, X_train, Y_train),
                         num_epochs, batch_size, learning_rate, key)
    run_epochs([trainer], [ds_train], [ds_test], num_epochs, nruns,
               SingleCheckpointer(net.folder, checkpoint_every,
                                  "gan_train_ckpt"),
               verbose, retain_every)
    return trainer.log
