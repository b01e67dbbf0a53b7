"""Inputs that the benchmark makes from `--seed` and hands to the program
and to the reference alike: keys of jobs and runs, fresh AndrewCNN
weights, and training samples. Everything is drawn on the run's device by
a `torch.Generator`, in a few large calls."""
from __future__ import annotations

import numpy as np
import torch

from .yardstick import ANDREW_KERNELS, andrew_layers

# keys of the streams that one seed feeds, kept apart
STREAMS = {"jobs": 1, "weights": 2, "data": 3, "train": 4, "sample": 5}


def stream_key(seed: int, stream: str, index: int = 0) -> int:
    """A key below 2**62 for stream `stream`, item `index`, of `seed`."""
    return (int(seed) % 2 ** 40 * 8 + STREAMS[stream]) * 4096 + int(index) \
        & (2 ** 62 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_key(seed, stream))


def andrew_variables(gen: torch.Generator, n_in: int, n_out: int,
                     hidden, std: float = 0.02) -> dict:
    """A flax tree of fresh AndrewCNN weights, as its published
    initialisation draws them: every kernel and every BatchNorm scale
    N(0, std^2), biases and BatchNorm shifts 0, running means 0 and
    variances 1; drawn in one call on the generator's device."""
    layers = andrew_layers(n_in, n_out, hidden, ANDREW_KERNELS)
    sizes = [k * k * ci * co for k, ci, co in layers] + list(hidden)
    flat = (torch.randn(sum(sizes), generator=gen, device=gen.device)
            * std).cpu().numpy()
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    params, stats = {}, {}
    for i, (k, ci, co) in enumerate(layers):
        params[f"Conv_{i}"] = {
            "kernel": parts[i].reshape(k, k, ci, co),
            "bias": np.zeros(co, np.float32)}
    for i, c in enumerate(hidden):
        params[f"BatchNorm_{i}"] = {"scale": parts[len(layers) + i],
                                    "bias": np.zeros(c, np.float32)}
        stats[f"BatchNorm_{i}"] = {"mean": np.zeros(c, np.float32),
                                   "var": np.ones(c, np.float32)}
    return {"params": params, "batch_stats": stats}


def samples(gen: torch.Generator, n: int, nx: int, channels: int = 2,
            dtype=torch.float32) -> torch.Tensor:
    """(n, nx, nx, channels) standard normal samples, NHWC."""
    return torch.randn((n, nx, nx, channels), generator=gen,
                       device=gen.device, dtype=dtype)
