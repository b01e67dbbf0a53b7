"""Verbatim copy of `pyqg_generative_tpu/qg/params.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Physics + run configuration for the two-layer QG core.

Defaults reproduce the configuration the reference drives through
`pyqg.QGModel(**params)` (reference `tools/parameters.py:36-37`,
`tools/simulate.py:121-126`): a doubly-periodic two-layer quasi-geostrophic
ocean on a beta-plane with background vertical shear, bottom drag on the lower
layer and an exponential small-scale spectral filter.

Everything here is *static* (compile-time) configuration: the traced solver
state lives in `qg.core.QGState`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

DAY = 86400.0
YEAR = 360 * DAY
# Snapshot interval used throughout the JAMES pipeline: 1000 steps of 3600 s
# (reference tools/parameters.py:42 `ANDREW_1000_STEPS`).
ANDREW_1000_STEPS = 3_600_000.0
AVERAGE_SLICE_ANDREW = slice(44, None)
SAMPLE_SLICE = slice(-40, None)


def dt_for_nx(nx: int) -> float:
    """Resolution-dependent stable timestep (reference tools/parameters.py:12-32)."""
    if nx == 1024:
        return 600.0
    if nx in (512, 2048):
        return 1800.0
    if nx == 256:
        return 3600.0
    if nx in (128, 96):
        return 7200.0
    if nx <= 64:
        return 14400.0
    raise ValueError(f"no dt rule for nx={nx}")


@dataclass(frozen=True)
class QGParams:
    """Two-layer QG configuration (immutable; hashable; jit-static).

    Physics defaults equal pyqg's QGModel defaults, which EDDY_PARAMS relies on
    (reference SURVEY §2.9 / tools/parameters.py:36).
    """
    nx: int = 64
    ny: int | None = None
    L: float = 1e6
    W: float | None = None
    # two-layer physics
    beta: float = 1.5e-11     # planetary vorticity gradient [1/m/s]
    rd: float = 15000.0       # deformation radius [m]
    delta: float = 0.25       # layer thickness ratio H1/H2
    H1: float = 500.0         # upper layer depth [m]
    U1: float = 0.025         # upper layer background zonal flow [m/s]
    U2: float = 0.0           # lower layer background zonal flow [m/s]
    rek: float = 5.787e-7     # linear bottom drag [1/s]
    # numerics
    dt: float = 14400.0
    tmax: float = 10 * YEAR
    tavestart: float = 5 * YEAR
    taveint: float = DAY      # diagnostics sampling interval [s]
    filterfac: float = 23.6   # ssd exponential filter steepness
    precision: str = "single"  # 'single' | 'double'

    # ------------------------------------------------------------ derived
    @property
    def ny_(self) -> int:
        return self.ny or self.nx

    @property
    def W_(self) -> float:
        return self.W or self.L

    @property
    def H2(self) -> float:
        return self.H1 / self.delta

    @property
    def H(self) -> float:
        return self.H1 + self.H2

    @property
    def del1(self) -> float:
        """Upper layer thickness fraction H1/H = delta/(1+delta)."""
        return self.delta / (1.0 + self.delta)

    @property
    def del2(self) -> float:
        return 1.0 / (1.0 + self.delta)

    @property
    def F1(self) -> float:
        """Stretching coefficient of the upper layer: q1 = lap(p1) + F1(p2-p1)."""
        return self.rd ** -2 / (1.0 + self.delta)

    @property
    def F2(self) -> float:
        return self.delta * self.F1

    @property
    def Us(self) -> float:
        """Background shear U1 - U2."""
        return self.U1 - self.U2

    @property
    def Qy(self) -> tuple[float, float]:
        """Background PV gradients per layer (beta +/- stretching of shear)."""
        return (self.beta + self.F1 * self.Us, self.beta - self.F2 * self.Us)

    @property
    def Ubg(self) -> tuple[float, float]:
        return (self.U1, self.U2)

    @property
    def dtype_real(self):
        return np.float64 if self.precision == "double" else np.float32

    @property
    def dtype_complex(self):
        return np.complex128 if self.precision == "double" else np.complex64

    @property
    def taveints(self) -> int:
        return max(1, int(np.ceil(self.taveint / self.dt)))

    # ------------------------------------------------------------ functional updates
    def replace(self, **kw) -> "QGParams":
        return dataclasses.replace(self, **kw)

    # mirror of the reference ConfigurationDict API (tools/parameters.py:3-32)
    def _update(self, d: dict) -> "QGParams":
        return self.replace(**d)

    def with_nx(self, nx: int) -> "QGParams":
        return self.replace(nx=nx, dt=dt_for_nx(nx))

    # convenient dict round-trip (CLI / model_args.json interop, no eval())
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "QGParams":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


EDDY_PARAMS = QGParams(nx=64, dt=14400.0, tmax=10 * YEAR, tavestart=5 * YEAR)
JET_PARAMS = EDDY_PARAMS.replace(rek=7e-08, delta=0.1, beta=1e-11)
