"""Helpers of the CNN closures: layouts, the saved scalers, the online
AndrewCNN chain, the draws of the offline programs, and MSE regression
training.

Twin of `pyqg_generative_tpu/models/common.py`: `nhwc_from_lev` /
`lev_from_nhwc`, extended to a leading member axis; `bn_apply` (:24),
`mse_loss_fn` (:34) and `train_regression` (:43), whose nets train on the
model's device under `device.exact_fp32_training` (PyTorch's own float32
convolutions, deterministic).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import exact_fp32, exact_fp32_training
from ..ml import train as T
from ..ml.fused_conv import VARIANTS, make_online_cnn
from ..ml.nets import divergence_head, fold_batchnorm
from ..ml.scalers import ChannelwiseScaler
from ..ml.weights import params_to_jax

__all__ = ["nhwc_from_lev", "lev_from_nhwc", "read_scalers", "set_scalers",
           "online_chain", "offline_variant", "draw_chunks", "OFFLINE_PIXELS",
           "bn_apply", "eval_in_batches", "mse_loss_fn", "train_regression"]

# Pixels a chain call of the offline programs holds: m draws of a batch of
# B images of H x W go through the kernel as one batch of m*B images, with
# m*B*H*W <= OFFLINE_PIXELS where B*H*W allows. At 64^2 that is 512 images,
# 1 GiB of the kernels' scratch (2 x 64 float32 channels a pixel) and 2 GiB
# of Conv_0's 128 channels.
OFFLINE_PIXELS = 512 * 64 * 64


def online_chain(variables: dict, compute_dtype, variant: str, device,
                 div: bool = False):
    """The online forward of an AndrewCNN's flax variables: BN-folded,
    Conv_0 in PyTorch and Conv_1..Conv_7 through the wrapper of the kernel
    `variant` names (`fused_conv.make_online_cnn`); with `div`, the chain
    is 4 wide and `divergence_head` follows. apply(x) carries the chain's
    `first_layer` and `packed` weights."""
    cnn = make_online_cnn(fold_batchnorm(variables), compute_dtype,
                          variant=variant, device=device)
    if not div:
        return cnn

    def apply(x):
        return divergence_head(cnn(x))

    apply.first_layer, apply.packed = cnn.first_layer, cnn.packed
    return apply


def offline_variant(variant: str) -> str:
    """The float32 variant an offline program runs for an online `variant`
    (a "...pair" name without its suffix): K2's "packed" stays K2, every
    other name is K1's "dx", which in float32 is the same kernel."""
    base = variant[:-len("pair")] if variant.endswith("pair") else variant
    return "packed" if VARIANTS.get(base) == "k2" else "dx"


def draw_chunks(generator: torch.Generator, M: int, batch_shape: tuple,
                latent: tuple, pixels: int):
    """M standard normal draws of shape batch_shape + latent from
    `generator`, in chunks of m draws, (m,) + batch_shape + latent, each
    drawn at once; m*pixels <= OFFLINE_PIXELS where pixels allow."""
    m = max(1, min(M, OFFLINE_PIXELS // max(pixels, 1)))
    for start in range(0, M, m):
        yield torch.randn((min(m, M - start),) + tuple(batch_shape)
                          + tuple(latent), generator=generator,
                          device=generator.device)


def read_scalers(model, folder: str) -> None:
    """Set `model.x_scale` and `model.y_scale` from a saved model's folder,
    and their standard deviations as tensors on `model.device`."""
    set_scalers(model, ChannelwiseScaler().read("x_scale.json", folder),
                ChannelwiseScaler().read("y_scale.json", folder))


def set_scalers(model, x_scale: ChannelwiseScaler,
                y_scale: ChannelwiseScaler) -> None:
    """Set `model.x_scale` and `model.y_scale`, and their standard
    deviations as tensors on `model.device`."""
    model.x_scale, model.y_scale = x_scale, y_scale
    model._x_std = torch.as_tensor(x_scale.std, device=model.device)
    model._y_std = torch.as_tensor(y_scale.std, device=model.device)


def nhwc_from_lev(q: torch.Tensor) -> torch.Tensor:
    """(lev, ny, nx) -> (1, ny, nx, lev); (B, lev, ny, nx) -> (B, ny, nx,
    lev)."""
    x = q.movedim(-3, -1)
    return x[None] if q.ndim == 3 else x


def lev_from_nhwc(x: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """(1, ny, nx, lev) -> (lev, ny, nx); with `batched`, (B, ny, nx, lev) ->
    (B, lev, ny, nx)."""
    return x.movedim(-1, -3) if batched else x[0].movedim(-1, 0)


# --------------------------------------------------------------------------
# MSE regression training
# --------------------------------------------------------------------------

def bn_apply(net: torch.nn.Module, x: torch.Tensor, train: bool):
    """`net` on x in train mode (its BatchNorm statistics updated, as the
    twin's `mutable=["batch_stats"]`) or eval mode, under `exact_fp32`."""
    net.train(train)
    with exact_fp32():
        return net(x)


def eval_in_batches(net: torch.nn.Module, X, device):
    """`net` in eval mode over the NHWC array X in batches of 64 on
    `device`, as a numpy array (the twin's jitted `bn_apply(..., False)`
    under `apply_in_batches`)."""
    def apply(x):
        with torch.no_grad():
            return bn_apply(net, x, False)
    return T.apply_in_batches(apply, X, device=device)


def mse_loss_fn(net: torch.nn.Module):
    """loss_fn(batch, train) -> (mean squared error, {"loss": it}) of `net`
    on batch = (x, y)."""
    def loss_fn(batch, train):
        x, y = batch
        loss = torch.mean((bn_apply(net, x, train) - y) ** 2)
        return loss, {"loss": loss}
    return loss_fn


def train_regression(net: torch.nn.Module, X_train, Y_train, X_test, Y_test,
                     num_epochs: int, batch_size: int, learning_rate: float,
                     rng=None, seed: int = 0, verbose=True, log_dict=None,
                     checkpoint_dir=None, checkpoint_every: int = 25):
    """Generic MSE regression training (reference tools/cnn_tools.py:645-700):
    `net`'s weights drawn afresh from a generator seeded with `seed` on its
    device, Adam on the reference's MultiStep schedule, the arrays moved to
    that device in its dtype. With `checkpoint_dir` the run checkpoints
    mid-way and resumes bit for bit (`ml.train.TrainCheckpointer`). Returns
    (the net's flax tree, the log)."""
    rng = rng or np.random.default_rng(0)
    p0 = next(net.parameters())
    generator = torch.Generator(device=p0.device).manual_seed(int(seed))
    steps = int(np.ceil(len(X_train) / batch_size))
    tx = T.multistep_adam(learning_rate, num_epochs, steps)
    state = T.init_training_state(net, tx, generator)

    def dev(a):
        return torch.as_tensor(a, dtype=p0.dtype, device=p0.device)

    with exact_fp32_training():
        state, log = T.fit(mse_loss_fn(net), state, tx,
                           (dev(X_train), dev(Y_train)),
                           (dev(X_test), dev(Y_test)), num_epochs,
                           batch_size, rng=rng, verbose=verbose,
                           log_dict=log_dict, checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every)
    return params_to_jax(net.state_dict()), log
