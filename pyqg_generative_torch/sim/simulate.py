"""Online simulation drivers.

Twin of the online half of `pyqg_generative_tpu/sim/simulate.py` (:41-284).
One step inverts PV, samples the closure's forcing, forms the spectral RHS,
accumulates the gated diagnostics and applies the filtered AB3 update, as in
the twin's `make_online_step`. Where JAX scans and vmaps one fused program,
here members are a leading batch axis and the steps a Python loop: the
diagnostics gate and the AB3 start are host branches on the shared step
counter, so the loop never waits on the device. Forcing-data generation
waits for a later slice.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..qg import core, diagnostics
from ..qg.grid import make_grid
from ..qg.params import ANDREW_1000_STEPS, DAY, QGParams
from ..utils import xrlite as xr
from .stochastic import init_sampler, sample_forcing

__all__ = ["run_ensemble", "set_initial_condition", "make_online_step",
           "init_run_carry"]


def set_initial_condition(p: QGParams, key: int = 0) -> torch.Tensor:
    """JAMES-paper initial condition (reference tools/simulate.py:147-168)."""
    return core.default_initial_q(p, rng=np.random.default_rng(int(key)))


def _normalize_parameterization(parameterization):
    """Accept the reference dict format {'self': model, 'sampling': ...,
    'nsteps': ...} or a bare model."""
    if parameterization is None:
        return None, "AR1", 1
    if isinstance(parameterization, Mapping):
        return (parameterization["self"],
                parameterization.get("sampling", "AR1"),
                int(parameterization.get("nsteps", 1)))
    return parameterization, "AR1", 1


def make_online_step(p: QGParams, model=None, sampling: str = "AR1",
                     nsteps: int = 1, with_diags: bool = True):
    """The per-step transition on carry
    (QGState, SamplerState|None, DiagAccumulator|None)."""
    rdt, cdt = core.dtypes(p)

    def step(carry):
        state, sstate, acc = carry
        flds = core.fields(state.qh, p)

        forcing_h = None
        if model is not None:
            def compute(noise):
                return model.online_forcing(flds, noise, p).to(rdt)

            def mean_fn():
                return model.online_mean_forcing(flds, p).to(rdt)

            forcing, sstate = sample_forcing(model, compute, sstate,
                                             sampling, nsteps, mean_fn)
            forcing_h = core.rfft2(forcing).to(cdt)

        dqhdt = core.advection_tendency(flds.q, flds.u, flds.v, flds.ph, p)
        dqhdt = dqhdt + core.friction_tendency(flds.ph, p)
        if forcing_h is not None:
            dqhdt = dqhdt + forcing_h

        if acc is not None and diagnostics.diag_gate(state, p):
            d = diagnostics.compute_diagnostics(
                flds, state.qh, p, forcing_h=forcing_h, dqhdt_post=dqhdt)
            acc = diagnostics.accumulate(acc, d)

        state = core.ab3_update(state, dqhdt, p)
        return state, sstate, acc

    return step


def _snapshot(state: core.QGState, p: QGParams) -> dict:
    flds = core.fields(state.qh, p)
    g = make_grid(p.nx, p.ny_, p.L, p.W_, p.filterfac)
    psi = core.irfft2(flds.ph, g.ny, g.nx).to(torch.float32)
    return {"q": flds.q.to(torch.float32), "u": flds.u.to(torch.float32),
            "v": flds.v.to(torch.float32), "psi": psi}


def init_run_carry(p: QGParams, q0, generator, model=None,
                   with_diags: bool = True, device=None):
    """Initial carry (QGState, SamplerState|None, DiagAccumulator|None) of a
    batch of members: q0 is (..., 2, ny, nx); `generator` a torch.Generator
    or a seed."""
    device = resolve_device(device)
    state = core.init_state(q0, p, device=device)
    batch = tuple(state.qh.shape[:-3])
    sstate = None
    if model is not None:
        sstate = init_sampler(generator, model, p.ny_, p.nx,
                              core.dtypes(p)[0], batch, device)
    acc = diagnostics.init_diags(p, model is not None, batch, device) \
        if with_diags else None
    return state, sstate, acc


def _advance_program(p: QGParams, model, sampling, nsteps,
                     steps_per_snap: int, n_snaps: int, with_diags: bool):
    """(carry) -> (carry, snapshots (..., n_snaps, 2, ny, nx), diagnostic
    means): a resumable segment of a simulation."""
    step = make_online_step(p, model, sampling, nsteps, with_diags)

    def advance(carry):
        snaps = []
        for _ in range(n_snaps):
            for _ in range(steps_per_snap):
                carry = step(carry)
            snaps.append(_snapshot(carry[0], p))
        stacked = {k: torch.stack([s[k] for s in snaps], dim=-4)
                   for k in snaps[0]}
        diags = diagnostics.finalize(carry[2]) if with_diags else {}
        return carry, stacked, diags

    return advance


def _simulate_program(p: QGParams, model, sampling, nsteps,
                      steps_per_snap: int, n_snaps: int, with_diags: bool):
    """A whole simulation as a function of (q0, generator, device)."""
    advance = _advance_program(p, model, sampling, nsteps, steps_per_snap,
                               n_snaps, with_diags)

    def run(q0, generator, device=None):
        carry = init_run_carry(p, q0, generator, model, with_diags, device)
        _, snaps, diags = advance(carry)
        return snaps, diags

    return run


def _grid_coords(p: QGParams) -> dict:
    g = make_grid(p.nx, p.ny_, p.L, p.W_, p.filterfac)
    return {"x": g.x[0, :], "y": g.y[:, 0], "lev": np.array([1, 2]),
            "l": g.ll, "k": g.kk}


def _build_dataset(snaps: dict, diags: dict, p: QGParams,
                   sampling_freq: float, n_snaps: int,
                   run_dim: bool = False) -> xr.Dataset:
    coords = _grid_coords(p)
    time_days = (np.arange(1, n_snaps + 1) * sampling_freq) / DAY
    lead = ("run", "time") if run_dim else ("time",)
    ds = xr.Dataset(attrs={"pyqg_params": str(p.to_dict())})
    for k, v in snaps.items():
        ds[k] = xr.DataArray(np.asarray(v), lead + ("lev", "y", "x"),
                             {"time": time_days, **coords})
    for k, v in diags.items():
        v = np.asarray(v, dtype=np.float32)
        dims = ("lev", "l", "k") if v.ndim - (1 if run_dim else 0) == 3 \
            else ("l", "k")
        ds[k] = xr.DataArray(v, (("run",) if run_dim else ()) + dims, coords)
    ds["time"] = xr.DataArray(time_days, ("time",),
                              attrs={"units": "days"})
    return ds


def run_ensemble(pyqg_params: QGParams, parameterization=None,
                 n_ens: int = 10, q_init=None,
                 sampling_freq: float = ANDREW_1000_STEPS,
                 key: int = 0, with_diags: bool = True,
                 device=None) -> xr.Dataset:
    """N online members advanced together as one batch. Member j starts from
    `set_initial_condition(p, key*1000 + j)` unless `q_init` is given; the
    latent noise comes from one generator seeded with `key`. `device=None`
    means CUDA."""
    p = pyqg_params
    device = resolve_device(device)
    model, sampling, nsteps = _normalize_parameterization(parameterization)
    steps_per_snap = max(1, int(round(sampling_freq / p.dt)))
    n_snaps = max(1, int(p.tmax // (steps_per_snap * p.dt)))
    rdt = core.dtypes(p)[0]
    if q_init is not None:
        q0 = torch.as_tensor(q_init, dtype=rdt)
        if q0.ndim == 3:
            q0 = q0.expand((n_ens,) + tuple(q0.shape))
    else:
        q0 = torch.stack([set_initial_condition(p, key * 1000 + j)
                          for j in range(n_ens)])
    generator = torch.Generator(device=device).manual_seed(int(key))
    program = _simulate_program(p, model, sampling, nsteps, steps_per_snap,
                                n_snaps, with_diags)
    snaps, diags = program(q0, generator, device)
    return _build_dataset({k: v.cpu().numpy() for k, v in snaps.items()},
                          {k: v.cpu().numpy() for k, v in diags.items()},
                          p, steps_per_snap * p.dt, n_snaps, run_dim=True)
