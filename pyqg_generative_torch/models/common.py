"""Helpers of the CNN closures: layouts, the saved scalers, the online
AndrewCNN chain and the draws of the offline programs.

Twin of `nhwc_from_lev` / `lev_from_nhwc` in
`pyqg_generative_tpu/models/common.py`, extended to a leading member axis.
"""
from __future__ import annotations

import torch

from ..ml.fused_conv import VARIANTS, make_online_cnn
from ..ml.nets import divergence_head, fold_batchnorm
from ..ml.scalers import ChannelwiseScaler

__all__ = ["nhwc_from_lev", "lev_from_nhwc", "read_scalers", "online_chain",
           "offline_variant", "draw_chunks", "OFFLINE_PIXELS"]

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
    model.x_scale = ChannelwiseScaler().read("x_scale.json", folder)
    model.y_scale = ChannelwiseScaler().read("y_scale.json", folder)
    model._x_std = torch.as_tensor(model.x_scale.std, device=model.device)
    model._y_std = torch.as_tensor(model.y_scale.std, device=model.device)


def nhwc_from_lev(q: torch.Tensor) -> torch.Tensor:
    """(lev, ny, nx) -> (1, ny, nx, lev); (B, lev, ny, nx) -> (B, ny, nx,
    lev)."""
    x = q.movedim(-3, -1)
    return x[None] if q.ndim == 3 else x


def lev_from_nhwc(x: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """(1, ny, nx, lev) -> (lev, ny, nx); with `batched`, (B, ny, nx, lev) ->
    (B, lev, ny, nx)."""
    return x.movedim(-1, -3) if batched else x[0].movedim(-1, 0)
