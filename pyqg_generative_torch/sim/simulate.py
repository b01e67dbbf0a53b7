"""Online simulation drivers.

Twin of the online half of `pyqg_generative_tpu/sim/simulate.py` (:41-332).
One step inverts PV, samples the closure's forcing, forms the spectral RHS,
accumulates the gated diagnostics and applies the filtered AB3 update, as in
the twin's `make_online_step`. Where JAX scans and vmaps one fused program,
here members are a leading batch axis and the steps a loop: the diagnostics
gate and the AB3 start are host branches on the shared step counter, so the
loop never waits on the device. On a card every driver advances its steps
through `graph.GraphedStep`, which replays each branch's step from a
captured CUDA graph (the twin's one program); on the CPU, which the caller
asks for, the eager step runs.

Forcing data (twin :335-436): a closure-free DNS whose steps between
snapshots replay a captured graph on a card, and at each snapshot the
coarse-graining operators and `PV_subgrid_forcing`, run eagerly, since
their transfer functions are built at first use, which no capture may do.
`generate_subgrid_forcing_batch` runs its members as one leading batch
axis, as `run_ensemble` does.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..qg import core, diagnostics
from ..qg.grid import make_grid
from ..qg.operators import OPERATORS, PV_subgrid_forcing
from ..qg.params import ANDREW_1000_STEPS, DAY, QGParams
from ..utils import xrlite as xr
from . import graph
from .stochastic import init_sampler, sample_forcing

__all__ = ["run_simulation", "run_ensemble", "run_ensemble_segmented",
           "set_initial_condition", "make_online_step", "init_run_carry",
           "advance_run", "run_with_snapshots", "generate_subgrid_forcing",
           "generate_subgrid_forcing_batch"]


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
                   with_diags: bool = True, device=None, rows=None):
    """Initial carry (QGState, SamplerState|None, DiagAccumulator|None) of a
    batch of members: q0 is (..., 2, ny, nx); `generator` a torch.Generator
    or a seed; `rows` as `init_sampler`'s, for a rank's block of a sharded
    ensemble."""
    device = resolve_device(device)
    state = core.init_state(q0, p, device=device)
    batch = tuple(state.qh.shape[:-3])
    sstate = None
    if model is not None:
        sstate = init_sampler(generator, model, p.ny_, p.nx,
                              core.dtypes(p)[0], batch, device, rows)
    acc = diagnostics.init_diags(p, model is not None, batch, device) \
        if with_diags else None
    return state, sstate, acc


def _advance_program(p: QGParams, model, sampling, nsteps,
                     steps_per_snap: int, n_snaps: int, with_diags: bool):
    """(carry) -> (carry, snapshots (..., n_snaps, 2, ny, nx), diagnostic
    means): a resumable segment of a simulation, graphed on a CUDA carry.
    The tensors of the carry passed in are left as they were."""
    def advance(carry):
        if carry[0].qh.is_cuda:
            step = graph.GraphedStep(p, model, sampling, nsteps, with_diags)
        else:
            step = make_online_step(p, model, sampling, nsteps, with_diags)
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

    def run(q0, generator, device=None, rows=None):
        carry = init_run_carry(p, q0, generator, model, with_diags, device,
                               rows)
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


def _snap_counts(p: QGParams, sampling_freq: float) -> tuple[int, int]:
    """(steps a snapshot, snapshots in p.tmax)."""
    steps_per_snap = max(1, int(round(sampling_freq / p.dt)))
    return steps_per_snap, max(1, int(p.tmax // (steps_per_snap * p.dt)))


def _to_numpy(tensors: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in tensors.items()}


def _ensemble_start(p: QGParams, n_ens: int, q_init, key: int, device):
    """(q0 (n_ens, 2, ny, nx), the noise generator) of an ensemble: member
    j starts from `set_initial_condition(p, key*1000 + j)` unless `q_init`
    is given, and one generator seeded with `key` draws every member's
    noise."""
    rdt = core.dtypes(p)[0]
    if q_init is not None:
        q0 = torch.as_tensor(q_init, dtype=rdt)
        if q0.ndim == 3:
            q0 = q0.expand((n_ens,) + tuple(q0.shape))
    else:
        q0 = torch.stack([set_initial_condition(p, key * 1000 + j)
                          for j in range(n_ens)])
    return q0, torch.Generator(device=device).manual_seed(int(key))


def advance_run(carry, pyqg_params: QGParams, parameterization=None,
                n_snaps: int = 1, sampling_freq: float = ANDREW_1000_STEPS,
                with_diags: bool = True, device=None):
    """Advance a run carry (`init_run_carry`) by `n_snaps` snapshot
    intervals. Returns (carry, Dataset segment) with the time coordinate
    shifted by the carry's starting step, and a leading `run` dim where the
    carry has a member axis; the carry passed in keeps its tensors. The
    carry must lie on `device` (None means CUDA)."""
    p = pyqg_params
    device = resolve_device(device)
    on = carry[0].qh.device
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"the carry lies on {on}, not on {device}")
    model, sampling, nsteps = _normalize_parameterization(parameterization)
    steps_per_snap, _ = _snap_counts(p, sampling_freq)
    tc0 = carry[0].tc
    advance = _advance_program(p, model, sampling, nsteps, steps_per_snap,
                               n_snaps, with_diags)
    carry, snaps, diags = advance(carry)
    ds = _build_dataset(_to_numpy(snaps), _to_numpy(diags), p,
                        steps_per_snap * p.dt, n_snaps,
                        run_dim=carry[0].qh.ndim > 3)
    # shift the time coordinate by the carry's starting step
    times = ds["time"].values + tc0 * p.dt / DAY
    for k in list(ds.keys()):
        if "time" in ds[k].coords:
            ds[k].coords["time"] = times
    ds["time"] = xr.DataArray(times, ("time",), attrs={"units": "days"})
    return carry, ds


def run_with_snapshots(pyqg_params: QGParams, parameterization=None,
                       q_init=None, sampling_freq: float = ANDREW_1000_STEPS,
                       key: int = 0, with_diags: bool = True, device=None):
    """Generator of (t seconds, Dataset of the newest snapshot and the
    running diagnostics), one per snapshot interval: pyqg's
    `run_with_snapshots` loop, advanced by `advance_run`. One member, no
    batch axis; its noise generator is seeded with `key`."""
    p = pyqg_params
    device = resolve_device(device)
    model, _, _ = _normalize_parameterization(parameterization)
    q0 = q_init if q_init is not None else set_initial_condition(p, key)
    carry = init_run_carry(p, q0, key, model, with_diags, device)
    for _ in range(_snap_counts(p, sampling_freq)[1]):
        carry, ds = advance_run(carry, p, parameterization, n_snaps=1,
                                sampling_freq=sampling_freq,
                                with_diags=with_diags, device=device)
        yield float(carry[0].t), ds


def run_simulation(pyqg_params: QGParams, parameterization=None,
                   q_init=None, sampling_freq: float = ANDREW_1000_STEPS,
                   key: int = 0, with_diags: bool = True,
                   device=None) -> xr.Dataset:
    """One online member, no batch axis: snapshots (time, lev, y, x) and
    diagnostics (lev, l, k) or (l, k). It starts from
    `set_initial_condition(p, key)` unless `q_init` is given, and its noise
    generator is seeded with `key`. `device=None` means CUDA."""
    p = pyqg_params
    device = resolve_device(device)
    model, sampling, nsteps = _normalize_parameterization(parameterization)
    steps_per_snap, n_snaps = _snap_counts(p, sampling_freq)
    q0 = q_init if q_init is not None else set_initial_condition(p, key)
    program = _simulate_program(p, model, sampling, nsteps, steps_per_snap,
                                n_snaps, with_diags)
    snaps, diags = program(q0, key, device)
    return _build_dataset(_to_numpy(snaps), _to_numpy(diags), p,
                          steps_per_snap * p.dt, n_snaps)


def run_ensemble(pyqg_params: QGParams, parameterization=None,
                 n_ens: int = 10, q_init=None,
                 sampling_freq: float = ANDREW_1000_STEPS,
                 key: int = 0, with_diags: bool = True,
                 device=None, sharding=None) -> xr.Dataset:
    """N online members advanced together as one batch. Member j starts from
    `set_initial_condition(p, key*1000 + j)` unless `q_init` is given; the
    latent noise comes from one generator seeded with `key`. `device=None`
    means CUDA (this rank's card).

    With `sharding` (`parallel.mesh.ensemble_sharding`), each rank of the
    mesh axis advances its block of members (`sharding.rows`, which raises
    unless the axis splits n_ens evenly) on its device, through the same
    graphed step, and every rank returns the whole Dataset
    (`sharding.gather`). Each rank draws the whole ensemble's noise from the
    generator seeded with `key` and keeps its rows, so member j of a sharded
    run draws what member j of the unsharded run draws."""
    p = pyqg_params
    device = resolve_device(device)
    model, sampling, nsteps = _normalize_parameterization(parameterization)
    steps_per_snap, n_snaps = _snap_counts(p, sampling_freq)
    q0, generator = _ensemble_start(p, n_ens, q_init, key, device)
    rows = None
    if sharding is not None:
        start, stop = sharding.rows(n_ens)
        q0, rows = q0[start:stop], (n_ens, start, stop)
    program = _simulate_program(p, model, sampling, nsteps, steps_per_snap,
                                n_snaps, with_diags)
    snaps, diags = program(q0, generator, device, rows)
    if sharding is not None:
        snaps = {k: sharding.gather(v) for k, v in snaps.items()}
        diags = {k: sharding.gather(v) for k, v in diags.items()}
    return _build_dataset(_to_numpy(snaps), _to_numpy(diags), p,
                          steps_per_snap * p.dt, n_snaps, run_dim=True)


def run_ensemble_segmented(pyqg_params: QGParams, parameterization=None,
                           n_ens: int = 10, q_init=None,
                           sampling_freq: float = ANDREW_1000_STEPS,
                           key: int = 0, with_diags: bool = True,
                           n_segments: int = 4,
                           device=None) -> xr.Dataset:
    """`run_ensemble` split into `n_segments` advances of one carry, with a
    host synchronisation (the snapshots' copy to the host) between them;
    equal to `run_ensemble`, since the carry is the whole state."""
    p = pyqg_params
    device = resolve_device(device)
    model, sampling, nsteps = _normalize_parameterization(parameterization)
    steps_per_snap, n_snaps = _snap_counts(p, sampling_freq)
    q0, generator = _ensemble_start(p, n_ens, q_init, key, device)
    carry = init_run_carry(p, q0, generator, model, with_diags, device)
    bounds = np.linspace(0, n_snaps, n_segments + 1).astype(int)
    seg_snaps, diags = [], {}
    for m in np.diff(bounds):
        if m == 0:
            continue
        advance = _advance_program(p, model, sampling, nsteps,
                                   steps_per_snap, int(m), with_diags)
        carry, snaps, diags = advance(carry)
        seg_snaps.append(_to_numpy(snaps))
    merged = {k: np.concatenate([s[k] for s in seg_snaps], axis=1)
              for k in seg_snaps[0]}
    return _build_dataset(merged, _to_numpy(diags), p,
                          steps_per_snap * p.dt, n_snaps, run_dim=True)


def _forcing_program(Nc: Sequence[int], p: QGParams, sampling_freq: float,
                     operators: Sequence[str], dealias: str):
    """The DNS and its per-snapshot coarse-graining, shared by the single
    run and the batch. Returns (program(q0 (..., 2, ny, nx), device) ->
    {combo: {var: (..., time, lev, y, x) float32 numpy}}, n_snaps,
    steps_per_snap)."""
    steps_per_snap, n_snaps = _snap_counts(p, sampling_freq)
    rdt = core.dtypes(p)[0]

    def program(q0, device):
        carry = (core.init_state(q0, p, device=device), None, None)
        if carry[0].qh.is_cuda:
            step = graph.GraphedStep(p, None, with_diags=False)
        else:
            step = make_online_step(p, None, with_diags=False)
        outs = {}
        for _ in range(n_snaps):
            for _ in range(steps_per_snap):
                carry = step(carry)
            q = core.irfft2(carry[0].qh, p.ny_, p.nx).to(rdt)
            for op_name in operators:
                op = OPERATORS[op_name]
                for nc in Nc:
                    S, (qc, uc, vc, psic) = PV_subgrid_forcing(
                        q, nc, op, p, dealias)
                    snap = {"q_forcing_advection": S, "q": qc, "u": uc,
                            "v": vc, "psi": psic}
                    combo = outs.setdefault(f"{op_name}-{nc}-dealias", {})
                    for k, v in snap.items():
                        combo.setdefault(k, []).append(v.to(torch.float32))
        return {c: {k: torch.stack(v, dim=-4).cpu().numpy()
                    for k, v in d.items()} for c, d in outs.items()}

    return program, n_snaps, steps_per_snap


def _forcing_to_datasets(outs: dict, p: QGParams, n_snaps: int,
                         steps_per_snap: int) -> dict:
    time_days = (np.arange(1, n_snaps + 1) * steps_per_snap * p.dt) / DAY
    result = {}
    for cname, data in outs.items():
        nc = int(cname.split("-")[1])
        pc = p.replace(nx=nc, ny=None)
        coords = _grid_coords(pc)
        ds = xr.Dataset(attrs={"pyqg_params": str(p.to_dict())})
        for vname, arr in data.items():
            ds[vname] = xr.DataArray(np.asarray(arr),
                                     ("time", "lev", "y", "x"),
                                     {"time": time_days, **coords})
        ds["time"] = xr.DataArray(time_days, ("time",),
                                  attrs={"units": "days"})
        result[cname] = ds
    return result


def generate_subgrid_forcing(Nc: Sequence[int], pyqg_params: QGParams,
                             sampling_freq: float = ANDREW_1000_STEPS,
                             operators: Sequence[str] = ("Operator2",
                                                         "Operator5"),
                             dealias: str = "3/2-rule",
                             key: int = 0, device=None) -> dict:
    """Run the DNS from `set_initial_condition(p, key)` and emit one
    training dataset of (S, q̄, ū, v̄, ψ̄) per (operator, resolution), keyed
    "{operator}-{nc}-dealias" (reference tools/simulate.py:62-106).
    `device=None` means CUDA."""
    p = pyqg_params
    device = resolve_device(device)
    program, n_snaps, steps_per_snap = _forcing_program(
        Nc, p, sampling_freq, operators, dealias)
    outs = program(set_initial_condition(p, key), device)
    return _forcing_to_datasets(outs, p, n_snaps, steps_per_snap)


def generate_subgrid_forcing_batch(Nc: Sequence[int],
                                   pyqg_params: QGParams,
                                   sampling_freq: float = ANDREW_1000_STEPS,
                                   operators: Sequence[str] = ("Operator2",
                                                               "Operator5"),
                                   dealias: str = "3/2-rule",
                                   keys: Sequence[int] = (0,),
                                   device=None) -> list:
    """`generate_subgrid_forcing` for one member a key, the members
    advanced together on a leading batch axis; a list of per-key dicts,
    each laid out as the single run's. `device=None` means CUDA."""
    p = pyqg_params
    device = resolve_device(device)
    program, n_snaps, steps_per_snap = _forcing_program(
        Nc, p, sampling_freq, operators, dealias)
    q0 = torch.stack([set_initial_condition(p, k) for k in keys])
    outs = program(q0, device)
    return [_forcing_to_datasets(
        {c: {v: a[j] for v, a in d.items()} for c, d in outs.items()},
        p, n_snaps, steps_per_snap) for j in range(len(keys))]
