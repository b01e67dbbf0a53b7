"""Helpers of the CNN closures: layouts and the saved scalers.

Twin of `nhwc_from_lev` / `lev_from_nhwc` in
`pyqg_generative_tpu/models/common.py`, extended to a leading member axis.
"""
from __future__ import annotations

import torch

from ..ml.scalers import ChannelwiseScaler

__all__ = ["nhwc_from_lev", "lev_from_nhwc", "read_scalers"]


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
