"""Parameterization base class (online hooks) and the model registry.

Twin of the online half of `pyqg_generative_tpu/models/base.py` (:43-57,
:125-163): a closure maps PV snapshots (..., lev, ny, nx) and latent noise
(..., ny, nx, n_latent) to a PV forcing, with the spatial mean removed per
layer. Leading axes are ensemble members. The offline test harness and the
persistence of trained models wait for the training slice.
"""
from __future__ import annotations

import json
import os

import torch

__all__ = ["Parameterization", "register_model", "load_model",
           "MODEL_REGISTRY"]

MODEL_REGISTRY: dict[str, type] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.__name__] = cls
    return cls


def load_model(folder: str = "model", device=None, **overrides):
    """Reload a saved model from its folder (the `model_args.json` contract
    the JAX package writes). `overrides` replace saved constructor arguments,
    e.g. `online_variant="tap"`; `device=None` means CUDA."""
    with open(os.path.join(folder, "model_args.json")) as f:
        args = json.load(f)
    name = args.pop("model")
    args.update(overrides)
    return MODEL_REGISTRY[name](folder=folder, device=device, **args)


class Parameterization:
    """Abstract stochastic subgrid closure."""

    def latent_shape(self, ny: int, nx: int) -> tuple:
        """Shape of one member's latent noise (NHWC, channels last)."""
        return (ny, nx, 0)

    def generate_latent_noise(self, generator: torch.Generator, ny: int,
                              nx: int, batch_shape=()) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + self.latent_shape(ny, nx),
                           dtype=torch.float32, device=generator.device)

    def predict_snapshot(self, q: torch.Tensor, noise: torch.Tensor):
        raise NotImplementedError

    def predict_mean_snapshot(self, q: torch.Tensor, M: int = 100):
        raise NotImplementedError

    def __call__(self, q, noise):
        """Online forcing: prediction with the spatial mean removed per layer
        (reference models/parameterization.py:23-34)."""
        pred = self.predict_snapshot(q, noise)
        return pred - pred.mean(dim=(-2, -1), keepdim=True)

    # hooks of the online step; ML closures see only q
    def online_forcing(self, flds, noise, p):
        return self(flds.q, noise)

    def online_mean_forcing(self, flds, p):
        pred = self.predict_mean_snapshot(flds.q)
        return pred - pred.mean(dim=(-2, -1), keepdim=True)
