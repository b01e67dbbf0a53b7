"""The two-layer quasi-geostrophic model with a CNN closure in the loop,
plain PyTorch.

Follows pyqg's `QGModel` (Abernathey et al., pyqg documentation, "Layered
quasigeostrophic model" with two layers) as Perezhogin, Zanna and
Fernandez-Granda (JAMES 2023, doi:10.1029/2023MS003681, section 2 and
appendix) run it in their eddy configuration:

* PV q_1 = lap psi_1 + F1 (psi_2 - psi_1), q_2 = lap psi_2 + F2 (psi_1 -
  psi_2), F1 = rd^-2 / (1 + delta), F2 = delta F1, inverted per wavenumber
  (the mean mode set to zero);
* dq/dt = -J(psi, q) - U_i dq/dx - Qy_i dpsi/dx (+ rek lap psi_2 on the
  lower layer) + the closure's forcing, the advection in flux form
  -d/dx((u + U_i) q) - d/dy(v q), Qy_1 = beta + F1 (U1 - U2), Qy_2 =
  beta - F2 (U1 - U2);
* third-order Adams-Bashforth (Euler, then second order, at the start),
  each step followed by the exponential filter exp(-23.6 (k* - 0.65 pi)^4)
  above the grid-normalised wavenumber k* = 0.65 pi;
* the JAMES initial condition (their `tools/simulate.py`): 1-D and 2-D
  white noise of amplitudes 1e-6 and 1e-7 in the upper layer, band-limited
  to the 32^2 model's wavenumbers;
* the stochastic closure sampled with the AR1 rule xi <- a xi + b eps, a =
  1 - 1/n, b = sqrt((2 - 1/n) / n), eps a fresh standard normal draw each
  step (n = 1: white noise), the forcing computed every step with its
  spatial mean removed per layer;
* pyqg's spectral diagnostics (KEspec, Ensspec, the energy and enstrophy
  fluxes and budgets, and the closure's contributions), sampled every
  `taveint` of model time from `tavestart` and averaged.

Departures: members are a leading batch axis; spectral fields are in
`torch.fft.rfftn` layout; the noise is drawn by a `torch.Generator` on the
run's device, seeded with the run's key, in the order the sampler needs it
(one draw of the whole batch at the start, one each step), as the
benchmark's traffic specifies. Real fields are float32, spectral complex64.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .cnn import AndrewCNN


@dataclass(frozen=True)
class Physics:
    nx: int
    dt: float
    L: float = 1e6
    beta: float = 1.5e-11
    rd: float = 15000.0
    delta: float = 0.25
    H1: float = 500.0
    U1: float = 0.025
    U2: float = 0.0
    rek: float = 5.787e-7
    filterfac: float = 23.6
    taveint: float = 86400.0
    tavestart: float = 0.0

    @property
    def F1(self):
        return self.rd ** -2 / (1.0 + self.delta)

    @property
    def F2(self):
        return self.delta * self.F1

    @property
    def Qy(self):
        return (self.beta + self.F1 * (self.U1 - self.U2),
                self.beta - self.F2 * (self.U1 - self.U2))

    @property
    def del1(self):
        return self.delta / (1.0 + self.delta)

    @property
    def del2(self):
        return 1.0 / (1.0 + self.delta)


def wavenumbers(nx: int, L: float) -> tuple[np.ndarray, np.ndarray]:
    """(k, l), float64, (nx, nx // 2 + 1): k >= 0 on the half axis, l
    signed on the full axis."""
    dk = 2.0 * np.pi / L
    k = dk * np.arange(0, nx // 2 + 1, dtype=np.float64)
    l = dk * np.append(np.arange(0, nx // 2, dtype=np.float64),
                       np.arange(-nx // 2, 0, dtype=np.float64))
    return (k[None, :] * np.ones((nx, 1)), l[:, None] * np.ones((1, nx // 2 + 1)))


def james_initial_condition(nx: int, L: float, key: int) -> np.ndarray:
    """(2, nx, nx) float32: the JAMES paper's initial PV of one run."""
    rng = np.random.default_rng(int(key))
    q2d = 1e-7 * rng.random((nx, nx))
    q2d -= q2d.mean(axis=(-2, -1), keepdims=True)
    q2d *= np.sqrt(nx * nx / 64 ** 2)
    q1d = 1e-6 * (np.ones((nx, 1)) * rng.random((1, nx)))
    q1d -= q1d.mean(axis=(-2, -1), keepdims=True)
    q1d *= np.sqrt(nx / 64)
    noise = q1d + q2d
    k, l = wavenumbers(nx, L)
    band = np.sqrt(k ** 2 + l ** 2) < np.pi / (L / 32)
    noise = np.fft.irfftn(np.fft.rfftn(noise) * band, s=(nx, nx),
                          axes=(-2, -1))
    return np.stack([noise, np.zeros_like(noise)]).astype(np.float32)


class Closure:
    """The CNN closure: forcing = G(q / x_std, noise) * y_std per level,
    its spatial mean removed; `noise` is (B, ny, nx, n_latent), as drawn."""

    def __init__(self, variables: dict, x_std, y_std, device,
                 mode: str = "float32"):
        self.net = AndrewCNN(variables, device)
        self.x_std = torch.tensor(np.asarray(x_std, np.float32),
                                  device=device)[None, :, None, None]
        self.y_std = torch.tensor(np.asarray(y_std, np.float32),
                                  device=device)[None, :, None, None]
        self.mode = mode

    def __call__(self, q: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        x = torch.cat([q / self.x_std, noise.permute(0, 3, 1, 2)], dim=1)
        y = self.net(x, mode=self.mode) * self.y_std
        return y - y.mean(dim=(-2, -1), keepdim=True)


class QGModel:
    """A batch of members of the two-layer model, float32, on `device`."""

    def __init__(self, phys: Physics, device):
        self.phys, self.device = phys, device
        n = phys.nx
        k, l = wavenumbers(n, phys.L)
        wv2 = k ** 2 + l ** 2
        dx = phys.L / n
        kstar = np.sqrt((k * dx) ** 2 + (l * dx) ** 2)
        cut = 0.65 * np.pi
        filt = np.where(kstar <= cut, 1.0,
                        np.exp(-phys.filterfac * (kstar - cut) ** 4))

        def real(a):
            return torch.tensor(a, dtype=torch.float32, device=device)

        self.wv2 = real(wv2)
        self.ik = torch.tensor(1j * k, dtype=torch.complex64, device=device)
        self.il = torch.tensor(1j * l, dtype=torch.complex64, device=device)
        self.filt = real(filt)
        det = wv2 * (wv2 + phys.F1 + phys.F2)
        self.inv_det = real(np.where(det > 0, 1.0 / np.where(det > 0, det, 1),
                                     0.0))
        self.U = real([phys.U1, phys.U2])[:, None, None]
        self.Qy = real(list(phys.Qy))[:, None, None]
        self.dels = real([phys.del1, phys.del2])[:, None, None]

    # ------------------------------------------------------------- fields
    def rfft(self, x):
        return torch.fft.rfftn(x, dim=(-2, -1))

    def irfft(self, xh):
        n = self.phys.nx
        return torch.fft.irfftn(xh, s=(n, n), dim=(-2, -1))

    def invert(self, qh):
        F1, F2 = self.phys.F1, self.phys.F2
        q1, q2 = qh[:, 0], qh[:, 1]
        p1 = (-(self.wv2 + F2) * q1 - F1 * q2) * self.inv_det
        p2 = (-F2 * q1 - (self.wv2 + F1) * q2) * self.inv_det
        return torch.stack([p1, p2], dim=1)

    def fields(self, qh):
        ph = self.invert(qh)
        return (ph, self.irfft(qh), self.irfft(-self.il * ph),
                self.irfft(self.ik * ph))

    def snapshot(self, qh) -> dict:
        ph, q, u, v = self.fields(qh)
        return {"q": q, "u": u, "v": v, "psi": self.irfft(ph)}

    # ------------------------------------------------------------ stepping
    def run(self, q0: torch.Tensor, closure, generators, n_latent: int,
            members: int, nsteps: int, steps_per_snap: int, n_snaps: int,
            diagnostics: bool = True):
        """Advance q0 (B, 2, ny, nx); the B members are blocks of `members`,
        block j drawing its noise from generators[j]. Returns (snapshots
        {q, u, v, psi}: (B, n_snaps, 2, ny, nx), diagnostic means)."""
        p = self.phys
        n = p.nx
        a = 1.0 - 1.0 / nsteps
        b = math.sqrt(1.0 / nsteps * (2.0 - 1.0 / nsteps))

        def draw():
            return torch.cat([torch.randn((members, n, n, n_latent),
                                          generator=g, device=self.device)
                              for g in generators])

        noise = draw()
        qh = self.rfft(q0.to(self.device))
        lag1 = lag2 = torch.zeros_like(qh)
        every = max(1, int(np.ceil(p.taveint / p.dt)))
        start = int(np.ceil(p.tavestart / p.dt))
        sums, count = {}, 0
        snaps = []
        for tc in range(steps_per_snap * n_snaps):
            ph, q, u, v = self.fields(qh)
            noise = a * noise + b * draw()
            fh = self.rfft(closure(q, noise))
            flux = self.rfft(torch.cat([(u + self.U) * q, v * q], dim=1))
            rhs = -(self.ik * flux[:, :2] + self.il * flux[:, 2:]) \
                - self.ik * (self.Qy * ph)
            drag = torch.zeros_like(rhs)
            drag[:, 1] = p.rek * self.wv2 * ph[:, 1]
            rhs = rhs + drag + fh
            if diagnostics and tc >= start and tc % every == 0:
                d = self.diagnostics(qh, ph, q, u, v, fh, rhs)
                sums = {k: sums.get(k, 0) + x for k, x in d.items()}
                count += 1
            if tc == 0:
                ca, cb, cc = 1.0, 0.0, 0.0
            elif tc == 1:
                ca, cb, cc = 1.5, -0.5, 0.0
            else:
                ca, cb, cc = 23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0
            qh = self.filt * (qh + p.dt * (ca * rhs + cb * lag1 + cc * lag2))
            lag1, lag2 = rhs, lag1
            if (tc + 1) % steps_per_snap == 0:
                snaps.append(self.snapshot(qh))
        stacked = {k: torch.stack([s[k] for s in snaps], dim=1)
                   for k in snaps[0]}
        means = {k: v / max(count, 1) for k, v in sums.items()}
        return stacked, means

    # --------------------------------------------------------- diagnostics
    def _advect(self, var, u, v):
        return -(self.ik * self.rfft(u * var) + self.il * self.rfft(v * var))

    def diagnostics(self, qh, ph, q, u, v, fh, rhs) -> dict:
        """pyqg's instantaneous spectral diagnostics, per member."""
        p = self.phys
        M2 = float(p.nx ** 2) ** 2
        wv2, dels = self.wv2, self.dels
        c_ape = p.del1 * p.del2 * p.rd ** -2
        ph1, ph2 = ph[:, 0], ph[:, 1]
        tauh = ph1 - ph2
        out = {"KEspec": wv2 * ph.abs() ** 2 / M2,
               "Ensspec": 0.5 * qh.abs() ** 2 / M2}
        xi = self.irfft(-wv2 * ph)
        out["KEflux"] = -(dels * (ph.conj() * self._advect(xi, u, v)).real
                          ).sum(dim=1) / M2
        ubt = p.del1 * u[:, 0] + p.del2 * u[:, 1]
        vbt = p.del1 * v[:, 0] + p.del2 * v[:, 1]
        tau = self.irfft(tauh)
        out["APEflux"] = c_ape * (tauh.conj() * self._advect(tau, ubt, vbt)
                                  ).real / M2
        out["APEgenspec"] = c_ape * (self.ik * (
            p.U1 * ph1.conj() * ph2 + p.U2 * ph2.conj() * ph1)).real / M2
        out["KEfrictionspec"] = -p.rek * p.del2 * wv2 * ph2.abs() ** 2 / M2
        out["ENSflux"] = (dels * (qh.conj() * self._advect(q, u, v)).real
                          ).sum(dim=1) / M2
        out["ENSgenspec"] = -(dels * self.Qy * (self.ik * qh.conj() * ph).real
                              ).sum(dim=1) / M2
        out["ENSfrictionspec"] = p.rek * p.del2 * wv2 * (
            qh[:, 1].conj() * ph2).real / M2
        out["entspec"] = (p.del1 * qh[:, 0] + p.del2 * qh[:, 1]).abs() ** 2 \
            / M2
        t_filt = (self.filt - 1.0) * (qh + p.dt * rhs) / p.dt
        out["Dissspec"] = -(dels * (ph.conj() * t_filt).real).sum(dim=1) / M2
        out["ENSDissspec"] = (dels * (qh.conj() * t_filt).real).sum(dim=1) \
            / M2
        out["paramspec"] = -(dels * (ph.conj() * fh).real).sum(dim=1) / M2
        dph = self.invert(fh)
        out["paramspec_KEflux"] = (dels * wv2 * (ph.conj() * dph).real
                                   ).sum(dim=1) / M2
        out["paramspec_APEflux"] = c_ape * (
            tauh.conj() * (dph[:, 0] - dph[:, 1])).real / M2
        out["ENSparamspec"] = (dels * (qh.conj() * fh).real).sum(dim=1) / M2
        return out
