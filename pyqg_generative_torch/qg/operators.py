"""Coarse-graining and filtering operators, and the subgrid forcings.

Twin of `pyqg_generative_tpu/qg/operators.py` (:36-315): every function acts
on the last two axes of a tensor of any leading shape, with the twin's
semantics (the reference's `tools/operators.py`), including the zeroing of
the 2h harmonics (Nyquist) that keeps truncated rFFT fields real and
invertible. FFTs go through `torch.fft` (cuFFT on the card), with the same
"backward" normalisation as `jnp.fft`.

Where the twin builds a grid and a transfer function (`np.exp(...)`) inside
every call, here each is built once per (sizes, L, filter, device, dtype) and
kept on the device (`_transfer`, `_spectral`), as `qg/core.py::consts` keeps
the solver's: a step captured as a CUDA graph copies no array to the card,
so the first eager step builds them before any capture. A transfer function
takes the real dtype of the spectrum it multiplies, as the twin's
`jnp.asarray(transm, Xf.real.dtype)` does; the 2/3-rule filter keeps
float64, as the twin's `jnp.asarray(g.filtr)` does.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from . import core
from .grid import make_grid
from .params import QGParams

__all__ = [
    "cut_off", "gauss_filter", "model_filter", "gcm_filter", "coarsegrain",
    "clean_2h", "fft_interpolate", "Operator1", "Operator2", "Operator3",
    "Operator4", "Operator5", "OPERATORS", "divergence", "advect",
    "PV_subgrid_forcing", "PV_subgrid_flux", "PV_forcing_total",
    "PV_forcing_true_total", "coarse_fields", "ave_lev",
]

FILTER_2h_HARMONICS = True


def _rfft2(x):
    return torch.fft.rfftn(x, dim=(-2, -1))


def _irfft2(xh, ny, nx):
    return torch.fft.irfftn(xh, s=(ny, nx), dim=(-2, -1))


def _real_dtype(xh: torch.Tensor) -> torch.dtype:
    return torch.float64 if xh.dtype == torch.complex128 else torch.float32


@lru_cache(maxsize=64)
def _transfer(kind: str, n: int, ratio: float, arg: float,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A spectral transfer function on the n x n grid of L = 1e6 m, on
    `device` in `dtype`: "gauss" (width `ratio` grid steps), "model" (the
    solver's filter at filterfac `arg`; 1e20 is the 2/3 rule) or "gcm"
    (`arg` steps of the discrete Laplacian, width `ratio`)."""
    if kind == "gauss":
        g = make_grid(n)
        a = np.exp(-g.wv2 * (ratio * g.dx) ** 2 / 24.0)
    elif kind == "model":
        a = make_grid(n, filterfac=arg).filtr
    elif kind == "gcm":
        g, n_steps = make_grid(n), int(arg)
        lam = (2.0 * np.cos(g.k * g.dx) + 2.0 * np.cos(g.l * g.dx)
               - 4.0) / g.dx ** 2
        a = (1.0 + (ratio * g.dx) ** 2 / (24.0 * n_steps) * lam) ** n_steps
    else:
        raise ValueError(kind)
    return torch.as_tensor(a, dtype=dtype, device=device)


@lru_cache(maxsize=64)
def _spectral(nx: int, ny: int, device: torch.device,
              dtype: torch.dtype) -> tuple:
    """(ik, il) of the nx x ny grid of L = 1e6 m, complex, on `device`."""
    g = make_grid(nx, ny, L=1e6)
    return (torch.as_tensor(g.ik, dtype=dtype, device=device),
            torch.as_tensor(g.il, dtype=dtype, device=device))


def ave_lev(arr, delta: float):
    """Depth-weighted average over a level axis of size 2 at -3
    (reference tools/operators.py:12-27)."""
    w1 = delta / (1.0 + delta)
    w2 = 1.0 / (1.0 + delta)
    return w1 * arr[..., 0, :, :] + w2 * arr[..., 1, :, :]


# --------------------------------------------------------------------------
# same-resolution filters
# --------------------------------------------------------------------------

def _filtered(X, kind: str, ratio: float = 0.0, arg: float = 0.0):
    n = X.shape[-1]
    Xf = _rfft2(X)
    t = _transfer(kind, n, float(ratio), float(arg), X.device,
                  _real_dtype(Xf))
    return _irfft2(Xf * t, X.shape[-2], n)


def gauss_filter(X, nc: int):
    """Spectral Gaussian filter of width ratio = n/nc grid steps:
    exp(-wv^2 (ratio*dx)^2 / 24) (reference tools/operators.py:84-90)."""
    return _filtered(X, "gauss", ratio=X.shape[-1] / nc)


def model_filter(X, nc: int | None = None, filterfac: float = 23.6):
    """The solver's exponential ssd filter at the input resolution
    (reference tools/operators.py:92-99). `nc` is ignored."""
    return _filtered(X, "model", arg=filterfac)


def gcm_filter(X, nc: int, n_steps: int = 16):
    """Grid-space diffusion-based Gaussian filter (gcm_filters semantics),
    (1 + L^2/(24 m) lap_5pt)^m with m = n_steps, applied spectrally (the
    twin's `gcm_filter`; reference tools/operators.py:73-82)."""
    return _filtered(X, "gcm", ratio=X.shape[-1] / nc,
                     arg=n_steps)


def clean_2h(X, nc: int | None = None):
    """Zero the non-invertible pure-real Nyquist harmonics (l=Nyq, k=0) and
    the whole k=Nyquist column (reference tools/operators.py:192-202)."""
    ny, nx = X.shape[-2], X.shape[-1]
    Xf = _rfft2(X)
    n = nx // 2
    Xf[..., n, 0] = 0
    Xf[..., :, n] = 0
    return _irfft2(Xf, ny, nx)


# --------------------------------------------------------------------------
# resolution-changing operators
# --------------------------------------------------------------------------

def coarsegrain(X, nc: int):
    """Box-average coarse-graining by an integer factor, then 2h cleaning
    (reference tools/operators.py:102-115)."""
    nx = X.shape[-1]
    if nx % nc != 0:
        raise ValueError("input size must be divisible by nc")
    r = nx // nc
    Y = X.reshape(X.shape[:-2] + (nc, r, nc, r)).mean(dim=(-3, -1))
    if FILTER_2h_HARMONICS:
        Y = clean_2h(Y)
    return Y


def cut_off(X, nc: int):
    """Sharp spectral truncation to an nc x nc grid with amplitude rescaling
    1/ratio^2 and 2h-harmonic zeroing (reference tools/operators.py:117-132).
    """
    if nc % 2 != 0:
        raise ValueError("nc must be even")
    ratio = X.shape[-1] / nc
    n = nc // 2
    Xf = _rfft2(X)
    trunc = torch.cat([Xf[..., :n, :n + 1], Xf[..., -n:, :n + 1]],
                      dim=-2) / ratio ** 2
    if FILTER_2h_HARMONICS:
        trunc[..., n, 0] = 0
        trunc[..., :, n] = 0
    return _irfft2(trunc, nc, nc)


def fft_interpolate(x, n: int, N: int, truncate_2h: bool = True):
    """FFT regridding n^2 -> N^2 (zero-pad or truncate), preserving resolved
    harmonics exactly (reference tools/operators.py:134-190)."""
    if x.shape[-2] != n or x.shape[-1] != n:
        raise ValueError("input must be n*n points")
    if n % 2 != 0 or N % 2 != 0:
        raise ValueError("grid sizes must be even")
    nn = min(n // 2, N // 2)
    xf = _rfft2(x)
    if truncate_2h:
        xf[..., nn, 0] = 0
    Xf = torch.zeros(x.shape[:-2] + (N, N // 2 + 1), dtype=xf.dtype,
                     device=xf.device)
    Xf[..., :nn, :nn + 1] = xf[..., :nn, :nn + 1]
    Xf[..., N - nn:, :nn + 1] = xf[..., n - nn:, :nn + 1]
    if truncate_2h:
        Xf[..., nn, 0] = 0
        Xf[..., :, nn] = 0
    return _irfft2(Xf, N, N) * (N / n) ** 2


# --------------------------------------------------------------------------
# composite operators (reference tools/operators.py:204-217)
# --------------------------------------------------------------------------

def Operator1(X, nc: int):
    """ssd-filter o sharp truncation (the paper's 'model filter' operator)."""
    return model_filter(cut_off(X, nc))


def Operator2(X, nc: int):
    """Gaussian (width 2 coarse cells) o sharp truncation."""
    return gauss_filter(cut_off(X, nc), nc // 2)


def Operator3(X, nc: int):
    """Box coarsegraining o Gaussian filter."""
    return coarsegrain(gcm_filter(X, nc), nc)


def Operator4(X, nc: int):
    return model_filter(Operator2(X, nc))


def Operator5(X, nc: int):
    """Pure sharp spectral truncation."""
    return cut_off(X, nc)


OPERATORS = {f.__name__: f for f in
             (Operator1, Operator2, Operator3, Operator4, Operator5)}


# --------------------------------------------------------------------------
# subgrid forcing diagnostics (reference tools/operators.py:241-330)
# --------------------------------------------------------------------------

def divergence(fx, fy):
    """Spectral divergence d/dx fx + d/dy fy over the last two axes, on the
    grid of L = 1e6 m."""
    ny, nx = fx.shape[-2], fx.shape[-1]
    Fx, Fy = _rfft2(fx), _rfft2(fy)
    ik, il = _spectral(nx, ny, Fx.device, Fx.dtype)
    return _irfft2(Fx * ik + Fy * il, ny, nx)


def advect(var, u, v, dealias: str = "none"):
    """Flux-form advection tendency +div(u*var, v*var) with optional
    dealiasing (reference tools/operators.py:249-268)."""
    if dealias == "none":
        return divergence(var * u, var * v)
    if dealias == "2/3-rule":
        ny, n = u.shape[-2], u.shape[-1]
        f = _transfer("model", n, 0.0, 1e20, u.device, torch.float64)

        def flt(x):
            return _irfft2(_rfft2(x) * f, ny, n)

        _var, _u, _v = flt(var), flt(u), flt(v)
        return flt(divergence(_var * _u, _var * _v))
    if dealias == "3/2-rule":
        n = u.shape[-1]
        N = int((n * 3) // 2)
        _var = fft_interpolate(var, n, N)
        _u = fft_interpolate(u, n, N)
        _v = fft_interpolate(v, n, N)
        var_u = fft_interpolate(_var * _u, N, n)
        var_v = fft_interpolate(_var * _v, N, n)
        return divergence(var_u, var_v)
    raise ValueError("dealias should be none, 2/3-rule or 3/2-rule")


def coarse_fields(q, nc: int, operator: Callable, p: QGParams):
    """Coarse-grain PV with `operator` and invert on the nc-grid:
    (q̄, ū, v̄, ψ̄) (reference tools/operators.py:219-236)."""
    pc = p.replace(nx=nc, ny=None)
    qf = operator(q, nc) if operator is not None else q
    st = core.init_state(qf, pc, device=q.device)
    flds = core.fields(st.qh, pc)
    psi = core.irfft2(flds.ph, nc, nc).to(core.dtypes(pc)[0])
    return flds.q, flds.u, flds.v, psi


def PV_subgrid_forcing(q, nc: int, operator: Callable, p: QGParams,
                       dealias: str = "none"):
    """Subgrid PV forcing S = adv(q̄, ū, v̄) − filter(adv(q, u, v))
    (reference tools/operators.py:283-287). Returns (S, (q̄, ū, v̄, ψ̄))."""
    ph = p.replace(nx=q.shape[-1], ny=None)
    qh_, uh_, vh_, _ = coarse_fields(q, q.shape[-1], None, ph)
    qc, uc, vc, psic = coarse_fields(q, nc, operator, p)
    forcing = advect(qc, uc, vc, dealias) - operator(
        advect(qh_, uh_, vh_, dealias), nc)
    return forcing, (qc, uc, vc, psic)


def PV_forcing_total(q, nc: int, operator: Callable, p: QGParams):
    """Total-tendency subgrid forcing: filter(dq/dt|hires) − dq/dt|coarse,
    the RHS with advection, mean terms and friction (reference
    tools/operators.py:289-307)."""
    ph = p.replace(nx=q.shape[-1], ny=None)
    pc = p.replace(nx=nc, ny=None)

    def tendency_real(qfield, pp):
        st = core.init_state(qfield, pp, device=q.device)
        flds = core.fields(st.qh, pp)
        dqhdt = core.advection_tendency(flds.q, flds.u, flds.v, flds.ph, pp)
        dqhdt = dqhdt + core.friction_tendency(flds.ph, pp)
        return core.irfft2(dqhdt, pp.ny_, pp.nx)

    t_hi = tendency_real(q, ph)
    t_lo = tendency_real(operator(q, nc), pc)
    return operator(t_hi, nc) - t_lo


def PV_forcing_true_total(q, nc: int, operator: Callable, p: QGParams):
    """Like PV_forcing_total but through one full filtered timestep:
    filter((q(t+dt) − q(t))/dt) differenced between resolutions
    (reference tools/operators.py:309-330)."""
    ph = p.replace(nx=q.shape[-1], ny=None)
    pc = p.replace(nx=nc, ny=None)

    def one_step_rate(qfield, pp):
        st = core.init_state(qfield, pp, device=q.device)
        st1 = core.step(st, pp)
        q1 = core.irfft2(st1.qh, pp.ny_, pp.nx)
        return (q1 - qfield) / pp.dt

    r_hi = one_step_rate(q, ph)
    r_lo = one_step_rate(operator(q, nc), pc)
    return operator(r_hi, nc) - r_lo


def PV_subgrid_flux(q, nc: int, operator: Callable, p: QGParams):
    """Subgrid PV fluxes (ū q̄ − filter(u q), v̄ q̄ − filter(v q))
    (reference tools/operators.py:270-281)."""
    ph = p.replace(nx=q.shape[-1], ny=None)
    qh_, uh_, vh_, _ = coarse_fields(q, q.shape[-1], None, ph)
    qc, uc, vc, _ = coarse_fields(q, nc, operator, p)
    uqflux = uc * qc - operator(uh_ * qh_, nc)
    vqflux = vc * qc - operator(vh_ * qh_, nc)
    return uqflux, vqflux
