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
applies it. Offline, `predict` is the GAN's mean and variance program on
the decoder (twin :224-260), in float32 through a BN-folded chain packed
for K1 or K2 (`common.offline_variant`; "packed" stays K2).
`use_optimal_epoch` switches the decoder to `decoder_opt.msgpack`, dropping
its packed weights, online and offline.

Training (twin :66-98, :140-176, :256-414): the encoder, an AndrewCNN from
(x, y) to per-pixel (mu, logvar) of the 2-channel latent at the default
widths, and the decoder as a torch module train together on the sigma-VAE
loss (`make_vae_loss`) by `train_CVAE`, under `exact_fp32_training`; the
latent's
eps comes from a torch.Generator seeded with `key`, as an argument of the
loss. After every epoch `vars_enc` and `vars_dec` are rewritten from the
trained modules and `weights_generation` grows, so that the offline
evaluation runs the new decoder; the best epoch's decoder is kept in
`decoder_opt.msgpack`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import exact_fp32, exact_fp32_training, resolve_device
from ..ml.fused_conv import compute_dtype_of
from ..ml.nets import AndrewCNN, init_weights
from ..ml.train import Adam, piecewise_constant_schedule
from ..ml.train_graph import COUNTERS, GraphedTrainStep
from ..ml.weights import params_from_jax, params_to_jax, read_msgpack
from ..utils.profiling import count, span
from .base import Parameterization, prepare_PV_data, register_model, \
    save_model_args, save_variables
from .cgan_regression import CGANRegression, GenerativeTrainer, \
    SingleCheckpointer, device_data, loss_to_dataset, run_epochs
from .common import bn_apply, lev_from_nhwc, \
    nhwc_from_lev, offline_variant, online_chain, read_scalers, \
    set_scalers, train_regression

__all__ = ["CVAERegression", "make_vae_loss", "make_vae_step", "train_CVAE",
           "VaeTrainer", "vae_batch", "vae_eps", "vae_optimizer",
           "vae_params"]


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

        def net(module):
            return module.to(self.device).eval()

        self.decoder = net(AndrewCNN(2 + self.n_latent, 2,
                                     hidden_channels=self.hidden_channels,
                                     div=div))
        self.encoder = net(AndrewCNN(4, 2 * self.n_latent))
        self.net_mean = net(AndrewCNN(2, 2, div=div)) \
            if regression != "None" else None
        self.vars_enc = None
        self.vars_dec = None
        self.vars_mean = None
        self._online_cache = None
        self._offline_cache = None
        self.load_model(folder)

    # --------------------------------------------------------------- fitting
    def fit(self, ds_train, ds_test, num_epochs: int = 200,
            num_epochs_regression: int = 50, batch_size: int = 64,
            learning_rate: float = 2e-4, nruns: int = 5,
            verbose: bool = True, key: int = 0,
            checkpoint_every: int = 25):
        X_train, Y_train, X_test, Y_test, x_scale, y_scale = \
            prepare_PV_data(ds_train, ds_test)
        set_scalers(self, x_scale, y_scale)
        if self.regression != "None":
            self.vars_mean, _ = train_regression(
                self.net_mean, X_train, Y_train, X_test, Y_test,
                num_epochs_regression, batch_size, 1e-3, verbose=verbose)
        log = train_CVAE(self, ds_train, ds_test, X_train, Y_train,
                         num_epochs, batch_size, learning_rate, nruns,
                         verbose=verbose, key=key,
                         checkpoint_every=checkpoint_every)
        self.save_model(log)

    def save_model(self, log=None):
        os.makedirs(self.folder, exist_ok=True)
        save_variables(self.vars_enc, f"{self.folder}/encoder.msgpack")
        save_variables(self.vars_dec, f"{self.folder}/decoder.msgpack")
        if self.regression != "None":
            save_variables(self.vars_mean, f"{self.folder}/net_mean.msgpack")
        self.x_scale.write("x_scale.json", self.folder)
        self.y_scale.write("y_scale.json", self.folder)
        save_model_args("CVAERegression", folder=self.folder,
                        regression=self.regression, div=self.div,
                        decoder_var=self.decoder_var,
                        hidden_channels=list(self.hidden_channels))
        if log:
            stats, epoch = loss_to_dataset(log)
            stats.to_npz(f"{self.folder}/stats.npz")
            print("Optimal epoch:", epoch)

    def load_model(self, folder) -> bool:
        """The folder's decoder, encoder (where `encoder.msgpack` is there:
        only training reads it), mean net and scalers."""
        if not self._load_decoder_file(f"{folder}/decoder.msgpack"):
            return False
        if os.path.exists(f"{folder}/encoder.msgpack"):
            self.vars_enc = read_msgpack(f"{folder}/encoder.msgpack")
            self.encoder.load_state_dict(params_from_jax(self.vars_enc))
        if self.net_mean is not None:
            self.vars_mean = read_msgpack(f"{folder}/net_mean.msgpack")
            self.net_mean.load_state_dict(params_from_jax(self.vars_mean))
        read_scalers(self, folder)
        return True

    def _load_decoder_file(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        self.vars_dec = read_msgpack(path)
        self.decoder.load_state_dict(params_from_jax(self.vars_dec))
        self._decoder_changed()
        return True

    def _decoder_changed(self) -> None:
        """Drop the decoder's packed weights, online and offline, and count
        a new generation."""
        self._online_cache = None
        self._offline_cache = None
        self.weights_generation += 1

    # ------------------------------------------------ training plumbing
    # (CVAEBottleneck has its own, for its flat deep latent)
    def _vae_modules(self) -> dict:
        return {"enc": self.encoder, "dec": self.decoder}

    def _init_vae_variables(self, generator: torch.Generator) -> None:
        """Fresh weights, drawn from `generator`, for the encoder and then
        the decoder, each only where the model has none (twin :140-154)."""
        if self.vars_enc is None:
            init_weights(self.encoder, generator)
        if self.vars_dec is None:
            init_weights(self.decoder, generator)

    def _set_vae_variables(self) -> None:
        """Rewrite `vars_enc` and `vars_dec` from the trained modules (twin
        :156-160)."""
        self.encoder.eval()
        self.decoder.eval()
        self.vars_enc = params_to_jax(self.encoder.state_dict())
        self.vars_dec = params_to_jax(self.decoder.state_dict())
        self._decoder_changed()

    def _encode_train(self, x, y, train):
        out = bn_apply(self.encoder, torch.cat([x, y], dim=-1), train)
        return out[..., :self.n_latent], out[..., self.n_latent:]

    def _decode_train(self, x, z, train):
        return bn_apply(self.decoder, torch.cat([x, z], dim=-1), train)

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

    # ---------------------------------------------------------------- offline
    def _offline_cnn(self):
        """The decoder's offline forward: its BN-folded chain packed in
        float32 for the kernel `offline_variant` names."""
        if self._offline_cache is None:
            self._offline_cache = online_chain(
                self.vars_dec, torch.float32,
                offline_variant(self.online_variant), self.device, self.div)
        return self._offline_cache

    _generate_draws = CGANRegression._generate_draws
    _mean_var_program = CGANRegression._mean_var_program
    _draws = CGANRegression._draws
    predict = CGANRegression.predict



# --------------------------------------------------------------------------


def vae_params(net) -> dict:
    """The trainable parameters of the VAE's modules, "enc.Conv_0.weight"
    and so on."""
    return {f"{m}.{k}": p for m, module in net._vae_modules().items()
            for k, p in module.named_parameters()}


def make_vae_loss(net):
    """The sigma-VAE objective (twin :256-289; reference
    models/cvae_regression.py:141-176): loss_fn(x, y, ymean, eps, train) ->
    (loss, metrics) on the model's modules, with eps the latent's standard
    normal draw, of shape (B,) + net.latent_shape(ny, nx). Loss = the
    pixel-summed MSE / (2 var_p) + the pixel-summed KL, batch-averaged;
    decoder_var "adaptive" takes var_p as the batch MSE without its
    gradient, "fixed" 1, else the number given."""

    def loss_fn(x, y, ymean, eps, train):
        mu, logvar = net._encode_train(x, y, train)
        std = torch.exp(0.5 * logvar)
        var = std ** 2
        z = eps * std + mu
        yhat = net._decode_train(x, z, train)
        if net.regression != "None":
            yhat = yhat + ymean

        b = x.shape[0]
        KL_pointwise = 0.5 * (mu ** 2 + var - 1.0 - logvar)
        MSE_pointwise = (yhat - y) ** 2
        if net.decoder_var == "adaptive":
            var_p = MSE_pointwise.mean().detach()
        elif net.decoder_var == "fixed":
            var_p = 1.0
        else:
            var_p = float(net.decoder_var)
        loss_recon = MSE_pointwise.reshape(b, -1).sum(-1).mean() / \
            (2.0 * var_p)
        loss_KL = KL_pointwise.reshape(b, -1).sum(-1).mean()
        loss = loss_recon + loss_KL
        metrics = {"loss": loss, "loss_recon": loss_recon,
                   "loss_KL": loss_KL, "MSE": MSE_pointwise.mean(),
                   "var_latent": var.mean(),
                   "var_aggr": mu.var(correction=0) + var.mean()}
        return loss, metrics

    return loss_fn


def make_vae_step(net, tx: Adam):
    """step(opt_state, batch, eps) -> metrics: one VAE update on batch =
    (x, y, ymean) in train mode under `exact_fp32_training` (the body of
    the twin's `train_epoch`, :337-347). `step.update(opt_state, batch,
    eps, scalars)` is the same step with Adam's scalars as the tensors
    that `Adam.scalars` wrote, and Adam's count left to the caller: the
    device work alone, which `VaeTrainer` captures in a CUDA graph."""
    loss_fn = make_vae_loss(net)
    params = vae_params(net)

    def run(opt_state, batch, eps, optimize):
        with exact_fp32_training():
            with span("train.forward"):
                loss, metrics = loss_fn(*batch, eps, True)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, list(params.values()))
            optimize(params, grads, opt_state)
        return {k: v.detach() for k, v in metrics.items()}

    def step(opt_state, batch, eps):
        return run(opt_state, batch, eps, tx.step)

    def update(opt_state, batch, eps, scalars):
        return run(opt_state, batch, eps, lambda params, grads, state:
                   tx.update(params, grads, state, scalars))

    step.update = update
    return step


def vae_optimizer(learning_rate: float, num_epochs: int, steps: int) -> Adam:
    """Adam(learning_rate), the rate times 0.1 at 1/2, 3/4 and 7/8 of the
    epochs' batches (twin :309-312)."""
    sched = [int(num_epochs * f) * steps for f in (0.5, 0.75, 0.875)]
    return Adam(piecewise_constant_schedule(learning_rate,
                                            {b: 0.1 for b in sched}))


def vae_eps(generator: torch.Generator, net, x: torch.Tensor):
    """The latent's standard normal draw for the batch x (B, ny, nx, C)."""
    B, ny, nx, _ = x.shape
    return torch.randn((B,) + tuple(net.latent_shape(ny, nx)),
                       generator=generator, device=generator.device,
                       dtype=x.dtype)


def vae_batch(data: tuple, generator: torch.Generator, net,
              idx: torch.Tensor) -> tuple:
    """((x, y, ymean), eps): the rows idx of the device-resident data (X,
    Y, the mean net's Y) and the latent's draw for them."""
    with span("train.batch"):
        Xd, Yd, Md = data
        x = Xd[idx]
        return (x, Yd[idx], Md[idx]), vae_eps(generator, net, x)


class VaeTrainer(GenerativeTrainer):
    """The VAE's replica (twin :292-414): Adam on `vae_optimizer`'s
    schedule, fresh weights for the encoder and then the decoder where the
    model has none, one `make_vae_step` a batch on the device-resident
    `data` (X, Y, the mean net's Y), its eps from the replica's generator
    (`vae_eps`).

    On CUDA data a step runs through `ml.train_graph.GraphedTrainStep`: the
    rows' gather, eps and `make_vae_step`'s update, eager at the first
    batch shape's first step, captured at its second and replayed after,
    bitwise the eager step; Adam's scalars are written before each step
    and its count advanced after it. On the CPU the step is eager, and
    counts `train.eager_steps`. The parameters, BatchNorm statistics and
    Adam's moments are updated in place and never replaced (`load` copies
    into them), since a graph holds their addresses."""

    best_file = "decoder_opt.msgpack"

    def __init__(self, net, data: tuple, num_epochs: int, batch_size: int,
                 learning_rate: float, key: int = 0):
        super().__init__(net, key, len(data[0]), batch_size)
        steps = int(np.ceil(self.n / batch_size))
        self.tx = vae_optimizer(learning_rate, num_epochs, steps)
        net._init_vae_variables(self.generator)
        params = vae_params(net)
        self.opt_state = self.tx.init(params)
        # Adam's scalars are kept for the parameters' device and dtype
        self._like = next(iter(params.values()))
        self.data = data
        self.vae_step = make_vae_step(net, self.tx)
        self.best_template = params_to_jax(net.decoder.state_dict())
        self.graphed = None
        if data[0].is_cuda:
            # the body holds the trainer's parts and not the trainer, so
            # that dropping the trainer frees its graph and pool at once
            tx, opt_state, vae_step = self.tx, self.opt_state, self.vae_step
            generator, like = self.generator, self._like

            def update(idx):
                batch, eps = vae_batch(data, generator, net, idx)
                return vae_step.update(opt_state, batch, eps,
                                       tx.scalars(like))
            self.graphed = GraphedTrainStep(update, (generator,))

    def step(self, i: int, idx: torch.Tensor) -> dict:
        with span("train.step"):
            if self.graphed is None:
                count(COUNTERS["eager_steps"])
                batch, eps = vae_batch(self.data, self.generator, self.net,
                                       idx)
                return self.vae_step(self.opt_state, batch, eps)
            self.tx.scalars(self._like, self.opt_state["count"])
            metrics = self.graphed(idx)
            self.opt_state["count"] += 1
            return metrics

    def trained(self) -> None:
        self.net._set_vae_variables()

    def best_vars(self) -> dict:
        return self.net.vars_dec

    def carry(self) -> dict:
        return {"modules": {k: m.state_dict()
                            for k, m in self.net._vae_modules().items()},
                "opt": self.opt_state}

    def load(self, saved: dict) -> None:
        """The saved modules and Adam state, copied into the trainer's own
        tensors."""
        for k, m in self.net._vae_modules().items():
            m.load_state_dict(saved["modules"][k])
        with torch.no_grad():
            for part in ("mu", "nu"):
                for name, t in self.opt_state[part].items():
                    t.copy_(saved["opt"][part][name])
        self.opt_state["count"] = int(saved["opt"]["count"])

    def describe(self, row: dict) -> str:
        return f"MSE: {row['MSE']:.4g} KL: {row['loss_KL']:.4g}"


def train_CVAE(net, ds_train, ds_test, X_train, Y_train,
               num_epochs: int, batch_size: int, learning_rate: float,
               nruns=5, verbose=True, key: int = 0,
               checkpoint_every: int = 25):
    """The VAE's training loop (twin :292-414), one `VaeTrainer`. The carry
    (the modules, the optimizer's state and the best decoder so far) is
    checkpointed to `vae_train_ckpt.npz` every `checkpoint_every` epochs;
    the best decoder by offline loss goes to `decoder_opt.msgpack`. Returns
    the log."""
    trainer = VaeTrainer(net, device_data(net, X_train, Y_train),
                         num_epochs, batch_size, learning_rate, key)
    run_epochs([trainer], [ds_train], [ds_test], num_epochs, nruns,
               SingleCheckpointer(net.folder, checkpoint_every,
                                  "vae_train_ckpt"), verbose, what="VAE")
    return trainer.log
