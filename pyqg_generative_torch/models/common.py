"""Layout helpers of the CNN closures.

Twin of `nhwc_from_lev` / `lev_from_nhwc` in
`pyqg_generative_tpu/models/common.py`, extended to a leading member axis.
"""
from __future__ import annotations

import torch

__all__ = ["nhwc_from_lev", "lev_from_nhwc"]


def nhwc_from_lev(q: torch.Tensor) -> torch.Tensor:
    """(lev, ny, nx) -> (1, ny, nx, lev); (B, lev, ny, nx) -> (B, ny, nx,
    lev)."""
    x = q.movedim(-3, -1)
    return x[None] if q.ndim == 3 else x


def lev_from_nhwc(x: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """(1, ny, nx, lev) -> (lev, ny, nx); with `batched`, (B, ny, nx, lev) ->
    (B, lev, ny, nx)."""
    return x.movedim(-1, -3) if batched else x[0].movedim(-1, 0)
