"""Noise time-samplers of the online closures.

Twin of `pyqg_generative_tpu/sim/stochastic.py`. The sampler state carries
the latent noise and cached forcing of every member (leading axes), a host
step counter that every member shares, and a `torch.Generator`:

* AR1(nsteps): xi_t = a xi_{t-1} + b eps, a = 1 - 1/n, b = sqrt((2-1/n)/n);
  n = 1 is white noise, n < 0 freezes the initial noise (a=1, b=0, and no
  draw). Forcing recomputed every step.
* constant(nsteps): fresh noise and forcing every n-th step, the cached
  forcing in between; the closure is skipped by a host branch on the counter
  (the twin's `lax.cond`).
* deterministic: the closure's ensemble-mean prediction every step.

Torch cannot reproduce JAX's threefry draws: the two packages agree on the
statistics of the noise, and exactly when both are handed the same noise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import resolve_device

__all__ = ["SamplerState", "init_sampler", "sample_forcing"]


@dataclasses.dataclass
class SamplerState:
    noise: torch.Tensor          # latent noise (..., model-defined shape)
    forcing: torch.Tensor        # cached PV forcing (..., 2, ny, nx)
    counter: int                 # steps since start, shared by all members
    generator: torch.Generator


def init_sampler(generator, model, ny: int, nx: int, dtype: torch.dtype,
                 batch_shape=(), device=None) -> SamplerState:
    """`generator` is a torch.Generator or an integer seed (then `device`
    says where the generator lives; `None` means CUDA)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=resolve_device(device)) \
            .manual_seed(int(generator))
    noise = model.generate_latent_noise(generator, ny, nx, batch_shape)
    forcing = torch.zeros(tuple(batch_shape) + (2, ny, nx), dtype=dtype,
                          device=generator.device)
    return SamplerState(noise=noise, forcing=forcing, counter=0,
                        generator=generator)


def _draw(sstate: SamplerState) -> torch.Tensor:
    noise = sstate.noise
    if noise.numel() == 0:
        return noise
    return torch.randn(noise.shape, generator=sstate.generator,
                       dtype=noise.dtype, device=noise.device)


def sample_forcing(model, compute: Callable, sstate: SamplerState,
                   sampling: str, nsteps: int,
                   mean_fn: Callable | None = None):
    """Return (forcing, new_state). `compute(noise) -> forcing` evaluates the
    closure on the current resolved state; `mean_fn() -> forcing` is the
    deterministic-mode prediction."""
    if sampling == "deterministic":
        return mean_fn(), sstate

    if sampling == "AR1":
        if nsteps > 0:
            a = 1.0 - 1.0 / nsteps
            b = (1.0 / nsteps * (2.0 - 1.0 / nsteps)) ** 0.5
            noise = a * sstate.noise + b * _draw(sstate)
        else:  # frozen noise
            noise = sstate.noise
        f = compute(noise).to(sstate.forcing.dtype)
        return f, dataclasses.replace(sstate, noise=noise, forcing=f,
                                      counter=sstate.counter + 1)

    if sampling == "constant":
        if sstate.counter % nsteps == 0:
            noise = _draw(sstate)
            f = compute(noise).to(sstate.forcing.dtype)
        else:
            noise, f = sstate.noise, sstate.forcing
        return f, dataclasses.replace(sstate, noise=noise, forcing=f,
                                      counter=sstate.counter + 1)

    raise ValueError(f"unknown sampling type {sampling}")
