"""Pointwise stencil MLP closure, online inference.

Twin of the online half of `pyqg_generative_tpu/models/ann_model.py`
(:29-38, :72-86, :113-133): an MLP maps each (stencil_size x stencil_size)
circular patch of one level's PV, divided by the saved `x_scale`, to the
forcing at its centre, times `y_scale` (both scalars in `scale.json`);
optionally scale-invariant, norm^2 * f(x / norm). The twin runs it through
XLA, so the port runs its dense layers through cuBLAS under `exact_fp32`.
Training waits for a later slice.
"""
from __future__ import annotations

import json
import os

import torch

from ..device import exact_fp32, resolve_device
from ..ml.nets import ANN
from ..ml.weights import params_from_jax, read_msgpack
from .base import Parameterization, register_model

__all__ = ["ANNModel", "stencil_stack"]


def stencil_stack(q: torch.Tensor, stencil_size: int = 3) -> torch.Tensor:
    """(..., ny, nx) -> (..., ny, nx, stencil_size^2) of circular patches,
    row-major over the (dy, dx) offsets; the centre is at index
    stencil_size^2 // 2."""
    s2 = stencil_size // 2
    return torch.stack([torch.roll(q, (-dy, -dx), dims=(-2, -1))
                        for dy in range(-s2, s2 + 1)
                        for dx in range(-s2, s2 + 1)], dim=-1)


@register_model
class ANNModel(Parameterization):
    def __init__(self, scale_invariant: bool = False, stencil_size: int = 3,
                 hidden_channels=(24, 24), folder: str = "model",
                 read: bool = True, device=None):
        self.device = resolve_device(device)
        self.folder = folder
        self.stencil_size = stencil_size
        self.hidden_channels = tuple(hidden_channels)
        self.scale_invariant = scale_invariant
        self.net = ANN(stencil_size ** 2, 1, self.hidden_channels,
                       degree=2 if scale_invariant else None).to(
            self.device).eval()
        self.variables = None
        if read:
            self.load_model(folder)

    def load_model(self, folder) -> bool:
        if not os.path.exists(f"{folder}/net.msgpack"):
            return False
        self.variables = read_msgpack(f"{folder}/net.msgpack")
        self.net.load_state_dict(params_from_jax(self.variables))
        with open(f"{folder}/scale.json") as f:
            scale = json.load(f)
        self.x_scale = scale["x_scale"]
        self.y_scale = scale["y_scale"]
        self.weights_generation += 1
        return True

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def _field_apply(self, q: torch.Tensor) -> torch.Tensor:
        """(..., ny, nx) -> the same shape, float32."""
        st = stencil_stack(q.to(torch.float32), self.stencil_size)
        with exact_fp32():
            y = self.net(st / self.x_scale)
        return self.y_scale * y.reshape(q.shape)

    def predict_snapshot(self, q, noise=None):
        return self._field_apply(q).to(q.dtype)

    def predict_mean_snapshot(self, q, M: int = 100):
        return self.predict_snapshot(q)
