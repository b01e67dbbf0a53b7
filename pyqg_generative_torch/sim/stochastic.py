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

__all__ = ["SamplerState", "init_sampler", "sample_forcing", "redraws"]


@dataclasses.dataclass
class SamplerState:
    noise: torch.Tensor          # latent noise (..., model-defined shape)
    forcing: torch.Tensor        # cached PV forcing (..., 2, ny, nx)
    counter: int                 # steps since start, shared by all members
    generator: torch.Generator
    # (members of the whole ensemble, start, stop) where this state holds
    # rows [start, stop) of a sharded ensemble: every draw is the whole
    # ensemble's, of which it keeps its rows, so that member j draws what it
    # draws unsharded
    rows: tuple | None = None


def init_sampler(generator, model, ny: int, nx: int, dtype: torch.dtype,
                 batch_shape=(), device=None, rows=None) -> SamplerState:
    """`generator` is a torch.Generator or an integer seed (then `device`
    says where the generator lives; `None` means CUDA). With `rows` =
    (members, start, stop), the state holds rows [start, stop) of an
    ensemble of `members` along the leading batch axis (`batch_shape`'s
    first entry is stop - start)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=resolve_device(device)) \
            .manual_seed(int(generator))
    if rows is None:
        noise = model.generate_latent_noise(generator, ny, nx, batch_shape)
    else:
        noise = model.generate_latent_noise(
            generator, ny, nx, (rows[0],) + tuple(batch_shape[1:])
        )[rows[1]:rows[2]]
    forcing = torch.zeros(tuple(batch_shape) + (2, ny, nx), dtype=dtype,
                          device=generator.device)
    return SamplerState(noise=noise, forcing=forcing, counter=0,
                        generator=generator, rows=rows)


def _draw(sstate: SamplerState) -> torch.Tensor:
    noise, rows = sstate.noise, sstate.rows
    if noise.numel() == 0:
        return noise
    if rows is None:
        return torch.randn(noise.shape, generator=sstate.generator,
                           dtype=noise.dtype, device=noise.device)
    return torch.randn((rows[0],) + tuple(noise.shape[1:]),
                       generator=sstate.generator, dtype=noise.dtype,
                       device=noise.device)[rows[1]:rows[2]]


def redraws(sstate: SamplerState, sampling: str, nsteps: int) -> bool:
    """The host branch of this step: whether the constant sampler draws new
    noise and recomputes the forcing (the twin's `lax.cond`). The other
    samplers do the same work every step."""
    return sampling == "constant" and sstate.counter % nsteps == 0


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
        if redraws(sstate, sampling, nsteps):
            noise = _draw(sstate)
            f = compute(noise).to(sstate.forcing.dtype)
        else:
            noise, f = sstate.noise, sstate.forcing
        return f, dataclasses.replace(sstate, noise=noise, forcing=f,
                                      counter=sstate.counter + 1)

    raise ValueError(f"unknown sampling type {sampling}")
