"""In-run spectral diagnostics of the two-layer QG core.

Twin of `pyqg_generative_tpu/qg/diagnostics.py`: the same keys and formulas
(derived from the solver's own RHS so that the energy budget closes), written
for a leading member axis. The accumulator's sample count and the sampling
gate are host values, because every member shares the step counter: the JAX
twin's `lax.cond` on `diag_gate` becomes an `if` in the step loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core import Fields, QGState, consts, dtypes, grid_for, invert, irfft2, \
    rfft2
from .params import QGParams

__all__ = ["DIAG_KEYS", "DiagAccumulator", "init_diags",
           "compute_diagnostics", "accumulate", "diag_gate", "finalize"]

# keys with a leading `lev` dimension
LAYERED_KEYS = ("KEspec", "Ensspec")
# depth-summed (single 2D plane) keys
FLAT_KEYS = ("KEflux", "APEflux", "APEgenspec", "KEfrictionspec",
             "ENSflux", "ENSgenspec", "ENSfrictionspec", "entspec",
             "Dissspec", "ENSDissspec")
PARAM_KEYS = ("paramspec", "paramspec_KEflux", "paramspec_APEflux",
              "ENSparamspec")
DIAG_KEYS = LAYERED_KEYS + FLAT_KEYS + PARAM_KEYS


@dataclasses.dataclass
class DiagAccumulator:
    sums: dict          # key -> (..., [2,] nl, nk) running sums
    count: float        # samples taken, shared by every member


def init_diags(p: QGParams, with_param: bool, batch_shape=(),
               device=None) -> DiagAccumulator:
    g = grid_for(p)
    keys = [(k, (2,)) for k in LAYERED_KEYS] + [(k, ()) for k in FLAT_KEYS]
    if with_param:
        keys += [(k, ()) for k in PARAM_KEYS]
    sums = {k: torch.zeros(tuple(batch_shape) + lev + (g.nl, g.nk),
                           dtype=dtypes(p)[0], device=device)
            for k, lev in keys}
    return DiagAccumulator(sums=sums, count=0.0)


def _advect_spec(var, u, v, c):
    """Spectral advective tendency -ik*F[u var] - il*F[v var] (flux form)."""
    return -(c.ik * rfft2(u * var) + c.il * rfft2(v * var))


def _lev_sum(w, x):
    """sum_i w_i x_i over the level axis (the twin's einsum 'i,ilk->lk')."""
    return (w * x).sum(dim=-3)


def compute_diagnostics(flds: Fields, qh: torch.Tensor, p: QGParams,
                        forcing_h: Optional[torch.Tensor] = None,
                        dqhdt_post: Optional[torch.Tensor] = None) -> dict:
    """Instantaneous 2D spectral diagnostics.

    forcing_h: spectral closure tendency (..., 2, nl, nk) or None.
    dqhdt_post: the full RHS used by the stepper (for the filter
        dissipation estimate); optional.
    """
    g = grid_for(p)
    c = consts(p, qh.device)
    rdt = dtypes(p)[0]
    M2 = float(g.M ** 2)
    wv2 = c.wv2
    dels = c.dels
    c_ape = p.del1 * p.del2 * p.rd ** -2
    ph = flds.ph
    ph1, ph2 = ph[..., 0, :, :], ph[..., 1, :, :]
    tauh = ph1 - ph2

    out = {}
    out["KEspec"] = (wv2 * ph.abs() ** 2) / M2
    out["Ensspec"] = 0.5 * qh.abs() ** 2 / M2

    # KE flux: advection of relative vorticity by perturbation velocities
    xi = irfft2(-wv2 * ph, g.ny, g.nx).to(rdt)
    Jpxi = _advect_spec(xi, flds.u, flds.v, c)
    out["KEflux"] = -_lev_sum(dels, (ph.conj() * Jpxi).real) / M2
    # APE flux: advection of baroclinic streamfunction by barotropic flow
    ubt = p.del1 * flds.u[..., 0, :, :] + p.del2 * flds.u[..., 1, :, :]
    vbt = p.del1 * flds.v[..., 0, :, :] + p.del2 * flds.v[..., 1, :, :]
    tau = irfft2(tauh, g.ny, g.nx).to(rdt)
    Jptpc = _advect_spec(tau, ubt, vbt, c)
    out["APEflux"] = c_ape * (tauh.conj() * Jptpc).real / M2

    # mean-flow energy generation (exact for this RHS)
    out["APEgenspec"] = c_ape * (
        c.ik * (p.U1 * ph1.conj() * ph2 + p.U2 * ph2.conj() * ph1)).real / M2

    # bottom drag
    out["KEfrictionspec"] = -p.rek * p.del2 * wv2 * ph2.abs() ** 2 / M2

    # enstrophy budget (weights del_i)
    adv = _advect_spec(flds.q, flds.u, flds.v, c)
    out["ENSflux"] = _lev_sum(dels, (qh.conj() * adv).real) / M2
    out["ENSgenspec"] = -_lev_sum(dels * c.Qy,
                                  (c.ik * qh.conj() * ph).real) / M2
    out["ENSfrictionspec"] = (p.rek * p.del2 * wv2
                              * (qh[..., 1, :, :].conj() * ph2).real) / M2

    # depth-averaged PV ("entropy") spectrum
    out["entspec"] = (p.del1 * qh[..., 0, :, :]
                      + p.del2 * qh[..., 1, :, :]).abs() ** 2 / M2

    # small-scale filter dissipation (effective tendency of the ssd filter)
    if dqhdt_post is not None:
        T_filt = (c.filtr - 1.0) * (qh + p.dt * dqhdt_post) / p.dt
        out["Dissspec"] = -_lev_sum(dels, (ph.conj() * T_filt).real) / M2
        out["ENSDissspec"] = _lev_sum(dels, (qh.conj() * T_filt).real) / M2
    else:
        out["Dissspec"] = torch.zeros_like(out["KEflux"])
        out["ENSDissspec"] = torch.zeros_like(out["KEflux"])

    # closure contribution
    if forcing_h is not None:
        out["paramspec"] = -_lev_sum(dels, (ph.conj() * forcing_h).real) / M2
        dph = invert(forcing_h, p)  # A^{-1} T: streamfunction tendency
        out["paramspec_KEflux"] = _lev_sum(
            dels, wv2 * (ph.conj() * dph).real) / M2
        out["paramspec_APEflux"] = c_ape * (
            tauh.conj() * (dph[..., 0, :, :] - dph[..., 1, :, :])).real / M2
        out["ENSparamspec"] = _lev_sum(dels,
                                       (qh.conj() * forcing_h).real) / M2
    return out


def accumulate(acc: DiagAccumulator, diags: dict) -> DiagAccumulator:
    sums = {k: acc.sums[k] + diags[k] for k in acc.sums}
    return DiagAccumulator(sums=sums, count=acc.count + 1.0)


def diag_gate(state: QGState, p: QGParams) -> bool:
    """True when diagnostics are sampled this step: t >= tavestart and every
    `taveints` steps (integer step arithmetic on the host counter)."""
    start_step = int(np.ceil(p.tavestart / p.dt))
    return state.tc >= start_step and state.tc % p.taveints == 0


def finalize(acc: DiagAccumulator) -> dict:
    """Running means."""
    denom = max(acc.count, 1.0)
    return {k: v / denom for k, v in acc.sums.items()}
