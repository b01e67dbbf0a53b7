"""Parameterization base class (online hooks), the model registry and the
folder contract's writers.

Twin of the online half of `pyqg_generative_tpu/models/base.py` (:43-66,
:125-163): a closure maps PV snapshots (..., lev, ny, nx) and latent noise
(..., model-defined shape) to a PV forcing, with the spatial mean removed
per layer. Leading axes are ensemble members. `save_model_args` and
`save_variables` write the twin's folder contract (`model_args.json`, flax
msgpack weights, written with `msgpack` alone). The offline test harness
waits for the evaluation slice.
"""
from __future__ import annotations

import json
import os

import torch

from ..ml.weights import to_msgpack_bytes

__all__ = ["Parameterization", "register_model", "load_model",
           "MODEL_REGISTRY", "save_model_args", "save_variables"]

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


def save_model_args(model_name: str, folder: str = "model", **kw):
    """`model_args.json`: the class name and its constructor arguments."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "model_args.json"), "w") as f:
        json.dump({"model": model_name, **kw}, f)


def save_variables(variables: dict, path: str):
    """A flax variable tree (numpy or torch arrays) as the bytes flax's
    `serialization.to_bytes` writes."""
    with open(path, "wb") as f:
        f.write(to_msgpack_bytes(variables))


class Parameterization:
    """Abstract stochastic subgrid closure.

    `weights_generation` counts the weight sets a model has loaded: a model
    that switches weights (`load_model`, `use_optimal_epoch`, ...) drops
    what it derived from the old ones and adds one, and a `GraphedStep`
    captured under one generation never replays under another."""

    weights_generation = 0

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
