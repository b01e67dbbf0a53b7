"""Two-layer quasi-geostrophic pseudo-spectral core in PyTorch.

Twin of `pyqg_generative_tpu/qg/core.py`; the physics, the operation order and
the float32/float64 precision rules are the same, so the two agree to rounding.
What differs is the idiom:

* the level axis is -3, and any leading axes are ensemble members, so one call
  advances a whole batch: real fields are (..., 2, ny, nx), spectral fields
  (..., 2, nl, nk) in `rfft2` layout;
* `QGState.t` and `QGState.tc` are host numbers, shared by every member, so
  the Euler -> AB2 -> AB3 start is a host branch on `tc` (the JAX twin's
  `jnp.where` on a traced counter) and the step loop never reads the device;
* FFTs go through `torch.fft` (cuFFT on the card), with the same "backward"
  normalisation as `jnp.fft`.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .grid import SpectralGrid, make_grid
from .params import QGParams

__all__ = [
    "QGState", "Fields", "grid_for", "init_state", "invert", "fields",
    "advection_tendency", "friction_tendency", "tendency", "ab3_update",
    "step", "default_initial_q", "cfl", "total_ke", "rfft2", "irfft2",
    "dtypes",
]

_TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64,
                np.complex64: torch.complex64, np.complex128: torch.complex128}


def grid_for(p: QGParams) -> SpectralGrid:
    return make_grid(p.nx, p.ny_, p.L, p.W_, p.filterfac)


def dtypes(p: QGParams) -> tuple[torch.dtype, torch.dtype]:
    """(real, complex) torch dtypes of the run precision."""
    return _TORCH_DTYPE[p.dtype_real], _TORCH_DTYPE[p.dtype_complex]


@lru_cache(maxsize=32)
def consts(p: QGParams, device: torch.device) -> SimpleNamespace:
    """Grid arrays cast to the run precision on `device`, built once per
    (configuration, device): the constants XLA embeds in the JAX twin."""
    g = grid_for(p)
    rdt, cdt = dtypes(p)

    def real(a):
        return torch.as_tensor(np.asarray(a), dtype=rdt, device=device)

    def cplx(a):
        return torch.as_tensor(np.asarray(a), dtype=cdt, device=device)

    wv2 = real(g.wv2)
    det = wv2 * (wv2 + p.F1 + p.F2)
    inv_det = torch.where(det > 0, 1.0 / torch.where(det == 0, 1.0, det),
                          0.0)
    return SimpleNamespace(
        wv2=wv2, inv_det=inv_det, ik=cplx(g.ik), il=cplx(g.il),
        filtr=real(g.filtr), Ubg=real(p.Ubg)[:, None, None],
        Qy=real(p.Qy)[:, None, None],
        dels=real([p.del1, p.del2])[:, None, None])


@dataclasses.dataclass
class QGState:
    """Solver state of a batch of members.

    `qh` is the spectral PV, (..., 2, nl, nk) complex; `dqhdt_p`/`dqhdt_pp`
    are the AB3 tendency lags. `t` (model seconds) and `tc` (step counter)
    are host numbers that every member shares.
    """
    qh: torch.Tensor
    dqhdt_p: torch.Tensor
    dqhdt_pp: torch.Tensor
    t: float
    tc: int


class Fields(NamedTuple):
    """Derived per-step fields shared by the stepper, closures and
    diagnostics."""
    ph: torch.Tensor   # (..., 2, nl, nk) complex streamfunction
    q: torch.Tensor    # (..., 2, ny, nx) real PV
    u: torch.Tensor    # (..., 2, ny, nx) real zonal perturbation velocity
    v: torch.Tensor    # (..., 2, ny, nx) real meridional velocity


def rfft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftn(x, dim=(-2, -1))


def irfft2(xh: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    return torch.fft.irfftn(xh, s=(ny, nx), dim=(-2, -1))


def invert(qh: torch.Tensor, p: QGParams) -> torch.Tensor:
    """Streamfunction from PV: the per-wavenumber 2x2 stretching system,
    with the mean mode (det == 0) gauge-fixed to zero."""
    c = consts(p, qh.device)
    wv2 = c.wv2
    F1, F2 = p.F1, p.F2
    q1h, q2h = qh[..., 0, :, :], qh[..., 1, :, :]
    p1h = (-(wv2 + F2) * q1h - F1 * q2h) * c.inv_det
    p2h = (-F2 * q1h - (wv2 + F1) * q2h) * c.inv_det
    return torch.stack([p1h, p2h], dim=-3).to(dtypes(p)[1])


def fields(qh: torch.Tensor, p: QGParams) -> Fields:
    """Invert PV and bring (q, u, v) to real space in one batched irfft2."""
    g = grid_for(p)
    c = consts(p, qh.device)
    ph = invert(qh, p)
    stacked = torch.cat([qh, -c.il * ph, c.ik * ph], dim=-3)
    quv = irfft2(stacked, g.ny, g.nx).to(dtypes(p)[0])
    nz = qh.shape[-3]
    return Fields(ph=ph, q=quv[..., :nz, :, :], u=quv[..., nz:2 * nz, :, :],
                  v=quv[..., 2 * nz:, :, :])


def advection_tendency(q, u, v, ph, p: QGParams) -> torch.Tensor:
    """dqh/dt = -ik F[(u+U_i) q] - il F[v q] - ik Qy_i ph (flux form)."""
    c = consts(p, q.device)
    flux = torch.cat([(u + c.Ubg) * q, v * q], dim=-3)
    fh = rfft2(flux)
    nz = q.shape[-3]
    uqh, vqh = fh[..., :nz, :, :], fh[..., nz:, :, :]
    return (-(c.ik * uqh + c.il * vqh) - c.ik * (c.Qy * ph)).to(dtypes(p)[1])


def friction_tendency(ph: torch.Tensor, p: QGParams) -> torch.Tensor:
    """Linear bottom drag on the lower layer: dq2h/dt += rek * wv2 * p2h."""
    c = consts(p, ph.device)
    bottom = (p.rek * c.wv2) * ph[..., -1, :, :]
    return torch.cat([torch.zeros_like(ph[..., :-1, :, :]),
                      bottom.unsqueeze(-3)], dim=-3)


def tendency(flds: Fields, qh, p: QGParams,
             forcing: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full spectral RHS: advection + friction (+ a real-space PV forcing
    (..., 2, ny, nx), the closure hook)."""
    rdt, cdt = dtypes(p)
    dqhdt = advection_tendency(flds.q, flds.u, flds.v, flds.ph, p)
    dqhdt = dqhdt + friction_tendency(flds.ph, p)
    if forcing is not None:
        dqhdt = dqhdt + rfft2(forcing.to(rdt)).to(cdt)
    return dqhdt


def ab3_coefficients(tc: int) -> tuple[float, float, float]:
    """Euler -> AB2 -> AB3 start, chosen on the host from the shared step
    counter."""
    if tc == 0:
        return 1.0, 0.0, 0.0
    if tc == 1:
        return 1.5, -0.5, 0.0
    return 23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0


def ab3_update(state: QGState, dqhdt: torch.Tensor, p: QGParams) -> QGState:
    """Filtered Adams-Bashforth step, pyqg semantics:
    qh <- filtr * (qh + dt*(a*f + b*f_p + c*f_pp))."""
    cst = consts(p, dqhdt.device)
    a, b, c = ab3_coefficients(state.tc)
    qtend = p.dt * (a * dqhdt + b * state.dqhdt_p + c * state.dqhdt_pp)
    qh = (cst.filtr * (state.qh + qtend)).to(dtypes(p)[1])
    return QGState(qh=qh, dqhdt_p=dqhdt, dqhdt_pp=state.dqhdt_p,
                   t=state.t + p.dt, tc=state.tc + 1)


def step(state: QGState, p: QGParams,
         forcing: Optional[torch.Tensor] = None) -> QGState:
    """One unparameterized (or externally forced) model step."""
    flds = fields(state.qh, p)
    dqhdt = tendency(flds, state.qh, p, forcing)
    return ab3_update(state, dqhdt, p)


# --------------------------------------------------------------------------
# initialization
# --------------------------------------------------------------------------

def init_state(q, p: QGParams, t: float = 0.0, device=None) -> QGState:
    """State from a real-space PV field (..., 2, ny, nx) (array or tensor)."""
    rdt, cdt = dtypes(p)
    q = torch.as_tensor(q, dtype=rdt, device=resolve_device(device))
    qh = rfft2(q).to(cdt)
    zeros = torch.zeros_like(qh)
    return QGState(qh=qh, dqhdt_p=zeros, dqhdt_pp=zeros,
                   t=float(t), tc=0)


def default_initial_q(p: QGParams, key=None,
                      rng: np.random.Generator | None = None) -> torch.Tensor:
    """JAMES-paper initial condition (numpy, bitwise equal to the twin's):
    zero-mean 1d+2d white noise truncated to the 32^2-model band, upper layer
    only. Returns a CPU tensor in the run precision."""
    g = grid_for(p)
    if rng is None:
        rng = np.random.default_rng(0 if key is None else np.asarray(key)[-1])
    q2d = 1e-7 * rng.random((g.ny, g.nx))
    q2d -= q2d.mean(axis=(-2, -1), keepdims=True)
    q2d *= np.sqrt(g.nx * g.ny / 64 ** 2)
    q1d = 1e-6 * (np.ones((g.ny, 1)) * rng.random((1, g.nx)))
    q1d -= q1d.mean(axis=(-2, -1), keepdims=True)
    q1d *= np.sqrt(g.nx / 64)
    noise = q1d + q2d
    nh = np.fft.rfftn(noise)
    noise = np.fft.irfftn(nh * (g.wv < np.pi / (p.L / 32)), s=(g.ny, g.nx),
                          axes=(-2, -1))
    q = np.stack([noise, np.zeros_like(noise)])
    return torch.from_numpy(q.astype(p.dtype_real))


# --------------------------------------------------------------------------
# scalar monitors (one value per member)
# --------------------------------------------------------------------------

def cfl(flds: Fields, p: QGParams) -> torch.Tensor:
    g = grid_for(p)
    c = consts(p, flds.u.device)
    umax = (flds.u + c.Ubg).abs().amax(dim=(-3, -2, -1))
    vmax = flds.v.abs().amax(dim=(-3, -2, -1))
    return torch.maximum(umax / g.dx, vmax / g.dy) * p.dt


def total_ke(flds: Fields, p: QGParams) -> torch.Tensor:
    """Depth-weighted mean kinetic energy 0.5*<u^2+v^2> (perturbation)."""
    c = consts(p, flds.u.device)
    return (0.5 * c.dels * (flds.u ** 2 + flds.v ** 2)).mean(
        dim=(-3, -2, -1)) * 2.0
