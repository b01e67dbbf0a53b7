"""Equation-based (non-ML) subgrid closures, the paper's comparators.

Twin of `pyqg_generative_tpu/models/physical.py` (:41-353), whose formulas
(Zanna-Bolton 2020, Smagorinsky, Jansen-Held biharmonic backscatter, ADM,
the scale-similarity Reynolds stress, the leading term of the symbolic
closure, Laplacian viscosity) and constants are the twin's. A closure is a
function of the resolved fields (u, v, psi, q), so it overrides the online
hooks `online_forcing` and `online_mean_forcing` to read `flds`.

What differs is the idiom: the fields carry any leading member axes (the
twin vmaps one member), so the backscatter's energy budget is summed over
the level axis (-3) and averaged over each member's grid; and the grid
constants (ik, il, wv2, dx), which the twin builds per call, are built once
per (grid, device, dtype) (`_consts`), so that a captured step copies no
array to the card. The offline `predict` on datasets waits for the
evaluation slice.
"""
from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from ..device import resolve_device
from ..qg import core
from ..qg.grid import make_grid
from ..qg.operators import advect, gauss_filter
from ..qg.params import QGParams
from .base import Parameterization, register_model

__all__ = ["PhysicalParameterization", "ZannaBolton2020", "Smagorinsky",
           "BackscatterBiharmonic", "BackscatterEddy", "BackscatterJet",
           "ADM", "ReynoldsStress", "HybridSymbolic", "Laplace",
           "BackscatterBiharmonicEddy", "BackscatterBiharmonicJet"]


def _complex_of(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype == torch.float64 \
        else torch.complex64


@lru_cache(maxsize=32)
def _consts(nx: int, ny: int, L: float, W: float, device: torch.device,
            dtype: torch.dtype) -> SimpleNamespace:
    """(ik, il) complex and wv2 real of the nx x ny grid of size L x W, in
    the complex dtype `dtype` and its real one, on `device`; and dx."""
    g = make_grid(nx, ny, L, W)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    return SimpleNamespace(
        ik=torch.as_tensor(g.ik, dtype=dtype, device=device),
        il=torch.as_tensor(g.il, dtype=dtype, device=device),
        wv2=torch.as_tensor(g.wv2, dtype=real, device=device), dx=g.dx)


@lru_cache(maxsize=32)
def _layer_weights(del1: float, del2: float, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The layers' depth fractions (2, 1, 1) on `device`."""
    return torch.tensor([del1, del2], dtype=dtype, device=device)[
        :, None, None]


def _grid(x: torch.Tensor, L: float = 1e6, W: float | None = None):
    """The constants of x's grid (its last two axes), in x's precision."""
    return _consts(x.shape[-1], x.shape[-2], L, W or L, x.device,
                   _complex_of(x))


def _rfft2(x):
    return torch.fft.rfftn(x, dim=(-2, -1))


def _irfft2(xh, ny, nx):
    return torch.fft.irfftn(xh, s=(ny, nx), dim=(-2, -1))


def _curl_to_q(du, dv):
    """Momentum forcing (du, dv) -> PV forcing via spectral curl dv_x - du_y
    (on the L = 1e6 m grid, as the twin's `_spectral`)."""
    ny, nx = du.shape[-2], du.shape[-1]
    c = _grid(du)
    return _irfft2(c.ik * _rfft2(dv) - c.il * _rfft2(du), ny, nx)


def _deformation(u, v):
    """(rel_vort, shearing, stretching) from layer velocities (…, ny, nx)."""
    ny, nx = u.shape[-2], u.shape[-1]
    uh, vh = _rfft2(u), _rfft2(v)
    c = _grid(u)
    rel_vort = _irfft2(c.ik * vh - c.il * uh, ny, nx)
    shearing = _irfft2(c.ik * vh + c.il * uh, ny, nx)
    stretching = _irfft2(c.ik * uh - c.il * vh, ny, nx)
    return rel_vort, shearing, stretching


class PhysicalParameterization(Parameterization):
    """Closure defined on the resolved Fields (needs u, v, psi, not just
    q). It holds no tensors; `device=None` means CUDA."""

    def __init__(self, folder: str = "model", device=None):
        self.folder = folder
        self.device = resolve_device(device)

    def forcing_from_fields(self, flds: core.Fields, p: QGParams):
        raise NotImplementedError

    def online_forcing(self, flds, noise, p):
        f = self.forcing_from_fields(flds, p)
        return f - f.mean(dim=(-2, -1), keepdim=True)

    def online_mean_forcing(self, flds, p):
        return self.online_forcing(flds, None, p)

    @torch.no_grad()
    def predict_snapshot(self, q, noise=None, p: QGParams | None = None):
        """The forcing of PV q (..., 2, ny, nx), computed in the precision of
        `p` (float32 by default, the twin's) on q's device."""
        p = p or QGParams(nx=q.shape[-1], precision="single")
        flds = core.fields(core.init_state(q, p, device=q.device).qh, p)
        return self.forcing_from_fields(flds, p).to(q.dtype)

    def predict_mean_snapshot(self, q, M: int = 100):
        return self.predict_snapshot(q)


@register_model
class ZannaBolton2020(PhysicalParameterization):
    """κ_BC closure of Zanna & Bolton 2020:
        S⃗ = κ ∇·[[ -ζσ_s + (ζ²+σ_n²+σ_s²)/2 ,  ζσ_n ],
                  [  ζσ_n ,  ζσ_s + (ζ²+σ_n²+σ_s²)/2 ]]
    with ζ relative vorticity, σ_n stretching, σ_s shearing deformation."""

    def __init__(self, constant: float = -46761284.0, folder: str = "model",
                 device=None, **kw):
        super().__init__(folder, device)
        self.constant = constant

    def forcing_from_fields(self, flds, p):
        u, v = flds.u, flds.v
        ny, nx = u.shape[-2], u.shape[-1]
        zeta, sig_s, sig_n = _deformation(u, v)
        c = _grid(u)
        rv_shear = _rfft2(zeta * sig_s)
        rv_stretch = _rfft2(zeta * sig_n)
        sum_sq = _rfft2((zeta ** 2 + sig_s ** 2 + sig_n ** 2) / 2.0)
        du = _irfft2(c.ik * (sum_sq - rv_shear) + c.il * rv_stretch, ny, nx)
        dv = _irfft2(c.il * (sum_sq + rv_shear) + c.ik * rv_stretch, ny, nx)
        return self.constant * _curl_to_q(du, dv)


@register_model
class Smagorinsky(PhysicalParameterization):
    """Classic Smagorinsky eddy viscosity nu = (Cs dx)^2 |S| applied to the
    momentum equations, curl-converted to a PV forcing."""

    def __init__(self, constant: float = 0.1, folder: str = "model",
                 device=None, **kw):
        super().__init__(folder, device)
        self.constant = constant

    def _nu(self, u, v, dx):
        _, sig_s, sig_n = _deformation(u, v)
        Smod = torch.sqrt(sig_n ** 2 + sig_s ** 2)
        return (self.constant * dx) ** 2 * Smod

    def forcing_from_fields(self, flds, p):
        u, v = flds.u, flds.v
        ny, nx = u.shape[-2], u.shape[-1]
        nu = self._nu(u, v, _grid(u, p.L, p.W_).dx)
        c = _grid(u)
        ux = _irfft2(c.ik * _rfft2(u), ny, nx)
        uy = _irfft2(c.il * _rfft2(u), ny, nx)
        vx = _irfft2(c.ik * _rfft2(v), ny, nx)
        vy = _irfft2(c.il * _rfft2(v), ny, nx)
        du = _irfft2(c.ik * _rfft2(2 * nu * ux)
                     + c.il * _rfft2(nu * (uy + vx)), ny, nx)
        dv = _irfft2(c.ik * _rfft2(nu * (vx + uy))
                     + c.il * _rfft2(2 * nu * vy), ny, nx)
        return _curl_to_q(du, dv)


@register_model
class BackscatterBiharmonic(PhysicalParameterization):
    """Jansen-Held biharmonic-Smagorinsky dissipation with energy
    backscatter:
    dq_diss = -lap(nu lap q),   nu = (Cs dx)^2 |S| dx^2
    eps     = sum_i del_i <psi_i dq_diss,i>     (energy removed per time)
    dq_back = c lap(psi),  c = back_constant * eps / (sum_i del_i <|u|^2>)
    with the sums over levels and the means over each member's grid."""

    def __init__(self, smag_constant: float = 0.08,
                 back_constant: float = 0.99, eps: float = 1e-32,
                 folder: str = "model", device=None, **kw):
        super().__init__(folder, device)
        self.smag_constant = smag_constant
        self.back_constant = back_constant
        self.eps = eps

    def forcing_from_fields(self, flds, p):
        u, v, ph, q = flds.u, flds.v, flds.ph, flds.q
        ny, nx = u.shape[-2], u.shape[-1]
        c = _grid(u, p.L, p.W_)
        _, sig_s, sig_n = _deformation(u, v)
        Smod = torch.sqrt(sig_n ** 2 + sig_s ** 2)
        nu = (self.smag_constant * c.dx) ** 2 * Smod * c.dx ** 2

        lap_q = _irfft2(-c.wv2 * _rfft2(q), ny, nx)
        dq_diss = -_irfft2(-c.wv2 * _rfft2(nu * lap_q), ny, nx)

        psi = _irfft2(ph, ny, nx).to(u.dtype)
        lap_psi = _irfft2(-c.wv2 * ph, ny, nx).to(u.dtype)
        dels = _layer_weights(p.del1, p.del2, u.device, u.dtype)
        # energy removed by dissipation (dE/dt = -sum del <psi T>), a member
        eps_removed = (dels * psi * dq_diss).sum(-3).mean(
            dim=(-2, -1), keepdim=True)
        grad_sq = (dels * (u ** 2 + v ** 2)).sum(-3).mean(
            dim=(-2, -1), keepdim=True)
        back = self.back_constant * eps_removed / (grad_sq + self.eps)
        return dq_diss + back.unsqueeze(-3) * lap_psi


def BackscatterEddy(folder: str = "model", device=None, **kw):
    return BackscatterBiharmonic(float(np.sqrt(0.007)), 1.2, folder=folder,
                                 device=device)


def BackscatterJet(folder: str = "model", device=None, **kw):
    return BackscatterBiharmonic(float(np.sqrt(0.005)), 0.8, folder=folder,
                                 device=device)


@register_model
class ADM(PhysicalParameterization):
    """Approximate deconvolution: van Cittert-invert the Gaussian test
    filter G (q* = sum_k (I-G)^k q̄) and estimate
        S = adv(q̄, ū, v̄) − G(adv(q*, u*, v*))."""

    def __init__(self, iterations: int = 5, folder: str = "model",
                 device=None, **kw):
        super().__init__(folder, device)
        self.iterations = iterations

    def _filter(self, x):
        return gauss_filter(x, x.shape[-1] // 2)  # width-2 Gaussian

    def _deconvolve(self, x):
        out = x
        corr = x
        for _ in range(self.iterations):
            corr = corr - self._filter(corr)
            out = out + corr
        return out

    def forcing_from_fields(self, flds, p):
        q, u, v = flds.q, flds.u, flds.v
        qs = self._deconvolve(q)
        us = self._deconvolve(u)
        vs = self._deconvolve(v)
        return advect(q, u, v) - self._filter(advect(qs, us, vs))


@register_model
class ReynoldsStress(PhysicalParameterization):
    """Scale-similarity (Bardina) Reynolds-stress closure: with a Gaussian
    test filter G, tau_ij = G(u_i u_j) - G(u_i) G(u_j), the forcing is
    -div(tau), curl-converted to PV (the twin's form; its provenance is
    stated there)."""

    def _filter(self, x):
        return gauss_filter(x, x.shape[-1] // 2)

    def forcing_from_fields(self, flds, p):
        u, v = flds.u, flds.v
        ny, nx = u.shape[-2], u.shape[-1]
        G = self._filter
        tau_uu = G(u * u) - G(u) * G(u)
        tau_uv = G(u * v) - G(u) * G(v)
        tau_vv = G(v * v) - G(v) * G(v)
        c = _grid(u)
        du = -_irfft2(c.ik * _rfft2(tau_uu) + c.il * _rfft2(tau_uv), ny, nx)
        dv = -_irfft2(c.ik * _rfft2(tau_uv) + c.il * _rfft2(tau_vv), ny, nx)
        return _curl_to_q(du, dv)


@register_model
class HybridSymbolic(PhysicalParameterization):
    """The leading term of the symbolic-regression closure (Ross et al.
    2023), S = kappa * dx^2 * lap(adv(q, u, v)) (the twin's form; its
    provenance is stated there)."""

    def __init__(self, kappa: float = -0.05, folder: str = "model",
                 device=None, **kw):
        super().__init__(folder, device)
        self.kappa = kappa

    def forcing_from_fields(self, flds, p):
        q, u, v = flds.q, flds.u, flds.v
        ny, nx = q.shape[-2], q.shape[-1]
        c = _grid(q, p.L, p.W_)
        tend = advect(q, u, v)
        lap = _irfft2(-c.wv2 * _rfft2(tend), ny, nx)
        return self.kappa * c.dx ** 2 * lap


@register_model
class Laplace(PhysicalParameterization):
    """Molecular-viscosity parameterization: dq = nu * lap(q) (PV=True) or
    nu * lap(lap(psi)) (reference tools/simulate.py:207-225)."""

    def __init__(self, nu: float = 0.0, PV: bool = False,
                 folder: str = "model", device=None, **kw):
        super().__init__(folder, device)
        self.nu = nu
        self.PV = PV

    def forcing_from_fields(self, flds, p):
        q = flds.q
        ny, nx = q.shape[-2], q.shape[-1]
        c = _grid(q, p.L, p.W_)
        if self.PV:
            field_h = _rfft2(q)
        else:
            field_h = -c.wv2 * flds.ph  # relative vorticity
        return self.nu * _irfft2(-c.wv2 * field_h, ny, nx)


# reference-name aliases for the registry
@register_model
class BackscatterBiharmonicEddy(BackscatterBiharmonic):
    def __init__(self, folder: str = "model", device=None, **kw):
        super().__init__(float(np.sqrt(0.007)), 1.2, folder=folder,
                         device=device)


@register_model
class BackscatterBiharmonicJet(BackscatterBiharmonic):
    def __init__(self, folder: str = "model", device=None, **kw):
        super().__init__(float(np.sqrt(0.005)), 0.8, folder=folder,
                         device=device)
