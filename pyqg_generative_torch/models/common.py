"""Helpers of the CNN closures: layouts, the saved scalers and the online
AndrewCNN chain.

Twin of `nhwc_from_lev` / `lev_from_nhwc` in
`pyqg_generative_tpu/models/common.py`, extended to a leading member axis.
"""
from __future__ import annotations

import torch

from ..ml.fused_conv import make_online_cnn
from ..ml.nets import divergence_head, fold_batchnorm
from ..ml.scalers import ChannelwiseScaler

__all__ = ["nhwc_from_lev", "lev_from_nhwc", "read_scalers", "online_chain"]


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
