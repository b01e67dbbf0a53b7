"""Verbatim copy of `pyqg_generative_tpu/qg/grid.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Spectral grid for the doubly-periodic pseudo-spectral solver.

Replaces the grid arrays the reference reads off `pyqg.QGModel` instances
(`kk, ll, k, l, ik, il, wv, wv2, filtr, dx, dk, dl`; see reference call sites
`tools/operators.py:89-99`, `tools/cnn_tools.py:109-111`,
`tools/spectral_tools.py:142-152`).

Layout: real fields are (..., ny, nx); spectral fields use `rfft2` layout
(..., ny, nx//2 + 1) with the *y*-wavenumber `ll` on the full-FFT axis and the
*x*-wavenumber `kk` on the half axis — identical to pyqg and to
`np.fft.rfftn(x, axes=(-2,-1))`.

Arrays are built once in float64 numpy and closed over as constants inside
jitted programs (XLA embeds them); dtype casting to the run precision happens
at use sites.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["SpectralGrid", "make_grid"]


class SpectralGrid:
    def __init__(self, nx: int, ny: int | None = None, L: float = 1e6,
                 W: float | None = None, filterfac: float = 23.6):
        ny = ny or nx
        W = W or L
        self.nx, self.ny, self.L, self.W = int(nx), int(ny), float(L), float(W)
        self.filterfac = float(filterfac)
        self.nl = self.ny
        self.nk = self.nx // 2 + 1
        self.M = self.nx * self.ny  # FFT normalization (pyqg's m.M)

        self.dx = self.L / self.nx
        self.dy = self.W / self.ny
        self.dk = 2.0 * np.pi / self.L
        self.dl = 2.0 * np.pi / self.W

        self.x, self.y = np.meshgrid(
            np.arange(0.5, self.nx) * self.dx,
            np.arange(0.5, self.ny) * self.dy)

        # 1d wavenumber arrays: kk >= 0 (rfft axis), ll signed (full axis)
        self.kk = self.dk * np.arange(0, self.nk, dtype=np.float64)
        self.ll = self.dl * np.append(
            np.arange(0, self.ny // 2, dtype=np.float64),
            np.arange(-self.ny // 2, 0, dtype=np.float64))

        self.k = self.kk[np.newaxis, :] * np.ones((self.nl, 1))
        self.l = self.ll[:, np.newaxis] * np.ones((1, self.nk))
        self.ik = 1j * self.k
        self.il = 1j * self.l
        self.wv2 = self.k ** 2 + self.l ** 2
        self.wv = np.sqrt(self.wv2)
        with np.errstate(divide="ignore"):
            self.wv2i = np.where(self.wv2 != 0.0, 1.0 / np.where(self.wv2 == 0, 1, self.wv2), 0.0)

        # exponential small-scale dissipation filter (pyqg semantics):
        # unity below the 0.65*pi cutoff in grid-normalized wavenumber, then
        # exp(-filterfac * (wvx - cphi)^4). filterfac=1e20 acts as a sharp
        # 2/3-rule-like cutoff (reference tools/simulate.py:231).
        cphi = 0.65 * np.pi
        wvx = np.sqrt((self.k * self.dx) ** 2 + (self.l * self.dy) ** 2)
        filtr = np.exp(-self.filterfac * (wvx - cphi) ** 4)
        self.filtr = np.where(wvx <= cphi, 1.0, filtr)

        # nondimensional cutoff useful for dealias masks
        self.wvx = wvx

    # ------------------------------------------------------------- helpers
    def fft(self, x):
        """rfft2 over the last two axes (numpy; for host-side use)."""
        return np.fft.rfftn(x, axes=(-2, -1))

    def ifft(self, xh):
        return np.fft.irfftn(xh, axes=(-2, -1), s=(self.ny, self.nx))

    def __repr__(self):
        return f"SpectralGrid(nx={self.nx}, ny={self.ny}, L={self.L:g})"


@lru_cache(maxsize=64)
def make_grid(nx: int, ny: int | None = None, L: float = 1e6,
              W: float | None = None, filterfac: float = 23.6) -> SpectralGrid:
    return SpectralGrid(nx, ny, L, W, filterfac)
