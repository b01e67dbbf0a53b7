"""The port's coarse-graining operators and subgrid forcings
(`pyqg_generative_torch/qg/operators.py`) against their JAX twins, on the
CPU: each operator in float64 on seeded numpy inputs, 32^2 -> 16^2, at rtol
1e-10 with atol 1e-12 of max|ref| (two FFT libraries rounding at float64;
the twin jitted, as its solver runs it); and the properties that
`tests/test_operators.py` checks of the twin, checked of the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqg_generative_torch.qg import operators as top
from pyqg_generative_torch.qg.grid import make_grid
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_tpu.qg import operators as jop
from pyqg_generative_tpu.qg.params import QGParams as JParams

torch.set_num_threads(1)

N, NC = 32, 16


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())


def band_limited(rng, n, kmax, nfields=1):
    """Random real fields whose spectra vanish for |k| or |l| >= kmax modes
    (the helper of tests/test_operators.py)."""
    out = []
    for _ in range(nfields):
        xh = np.zeros((n, n // 2 + 1), dtype=complex)
        xh[:kmax, :kmax] = rng.standard_normal((kmax, kmax)) + \
            1j * rng.standard_normal((kmax, kmax))
        xh[-kmax + 1:, :kmax] = rng.standard_normal((kmax - 1, kmax)) + \
            1j * rng.standard_normal((kmax - 1, kmax))
        xh[0, 0] = 0.0
        x = np.fft.irfftn(xh, s=(n, n), axes=(-2, -1))
        out.append(x / x.std())
    return out[0] if nfields == 1 else out


@pytest.fixture(scope="module")
def fields():
    """A PV field (2 members, 2 layers, 32^2) at an eddy amplitude, and
    three unit fields, float64."""
    rng = np.random.default_rng(21)
    q = 1e-5 * rng.standard_normal((2, 2, N, N))
    return q, rng.standard_normal((3, 2, 2, N, N))


# name -> (port call, twin call) on (q, the unit fields)
SAME_GRID = {
    "ave_lev": lambda op, q, f: op.ave_lev(q, 0.25),
    "gauss_filter": lambda op, q, f: op.gauss_filter(q, NC),
    "model_filter": lambda op, q, f: op.model_filter(q),
    "model_filter_sharp": lambda op, q, f: op.model_filter(q, None, 1e20),
    "gcm_filter": lambda op, q, f: op.gcm_filter(q, NC),
    "gcm_filter_8_steps": lambda op, q, f: op.gcm_filter(q, NC, 8),
    "clean_2h": lambda op, q, f: op.clean_2h(q),
    "divergence": lambda op, q, f: op.divergence(f[0], f[1]),
    "advect": lambda op, q, f: op.advect(q, f[0], f[1]),
    "advect_2/3": lambda op, q, f: op.advect(q, f[0], f[1], "2/3-rule"),
    "advect_3/2": lambda op, q, f: op.advect(q, f[0], f[1], "3/2-rule"),
}
COARSENING = {
    "coarsegrain": lambda op, q: op.coarsegrain(q, NC),
    "cut_off": lambda op, q: op.cut_off(q, NC),
    "fft_interpolate_down": lambda op, q: op.fft_interpolate(q, N, NC),
    "fft_interpolate_up": lambda op, q: op.fft_interpolate(q, N, 48),
    "fft_interpolate_keep_2h": lambda op, q: op.fft_interpolate(
        q, N, 48, truncate_2h=False),
    **{f"Operator{i}": (lambda op, q, i=i: getattr(op, f"Operator{i}")(
        q, NC)) for i in range(1, 6)},
}


def _port(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("name", sorted(SAME_GRID))
def test_same_grid_operator_matches_twin(fields, name):
    q, f = fields
    fn = SAME_GRID[name]
    ref = jax.jit(lambda q, f: fn(jop, q, f))(
        jnp.asarray(q), [jnp.asarray(a) for a in f])
    _close(fn(top, _port(q), [_port(a) for a in f]), ref)


@pytest.mark.parametrize("name", sorted(COARSENING))
def test_coarsening_operator_matches_twin(fields, name):
    q, _ = fields
    fn = COARSENING[name]
    _close(fn(top, _port(q)), jax.jit(lambda q: fn(jop, q))(jnp.asarray(q)))


FORCINGS = ["PV_subgrid_forcing", "PV_forcing_total",
            "PV_forcing_true_total", "PV_subgrid_flux", "coarse_fields"]


@pytest.mark.parametrize("name", FORCINGS)
@pytest.mark.parametrize("operator", ["Operator1", "Operator3"])
def test_subgrid_forcing_matches_twin(fields, name, operator):
    """The subgrid forcings of one member's PV, and the coarse fields, in
    float64 (precision "double"), through a spectral and a box operator."""
    q = fields[0][0]
    kw = dict(nx=NC, precision="double")
    args = [(_port(q), NC, getattr(top, operator), TParams(**kw)),
            (jnp.asarray(q), NC, getattr(jop, operator), JParams(**kw))]
    if name == "PV_subgrid_forcing":
        args = [a + ("3/2-rule",) for a in args]
    out = getattr(top, name)(*args[0])
    ref = jax.jit(lambda q: getattr(jop, name)(q, *args[1][1:]))(args[1][0])
    if name == "PV_subgrid_forcing":
        out, ref = (out[0],) + out[1], (ref[0],) + ref[1]
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r)


def test_transfer_functions_built_once(fields):
    """A transfer function or wavenumber table is built once per grid,
    device and dtype and then reused: a step captured as a CUDA graph copies
    no array to the card."""
    q = _port(fields[0])
    top.gauss_filter(q, NC)
    top.divergence(q, q)
    before = (top._transfer.cache_info().misses,
              top._spectral.cache_info().misses)
    for _ in range(3):
        top.gauss_filter(q, NC)
        top.divergence(q, q)
    assert (top._transfer.cache_info().misses,
            top._spectral.cache_info().misses) == before
    t32 = top._transfer("gauss", N, 2.0, 0.0, q.device, torch.float32)
    assert t32.dtype == torch.float32
    assert top._transfer("gauss", N, 2.0, 0.0, q.device,
                         torch.float32) is t32


# ---- the properties of tests/test_operators.py, of the port ----

def test_cut_off_preserves_low_modes(rng):
    n, nc = 64, 16
    x = band_limited(rng, n, kmax=6)
    y = top.cut_off(_port(x), nc).numpy()
    xh = np.fft.rfftn(x) / n ** 2
    yh = np.fft.rfftn(y) / nc ** 2
    np.testing.assert_allclose(yh[:6, :6], xh[:6, :6], atol=1e-12)
    np.testing.assert_allclose(yh[-5:, :6], xh[-5:, :6], atol=1e-12)


def test_cut_off_zeroes_2h_harmonics(rng):
    n, nc = 64, 16
    yh = np.fft.rfftn(top.cut_off(_port(rng.standard_normal((n, n))),
                                  nc).numpy())
    assert abs(yh[nc // 2, 0]) < 1e-10
    np.testing.assert_allclose(abs(yh[:, nc // 2]), 0.0, atol=1e-10)


def test_cut_off_batched(rng):
    x = rng.standard_normal((2, 3, 32, 32))
    y = top.cut_off(_port(x), 16).numpy()
    assert y.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(y[1, 2], top.cut_off(_port(x[1, 2]),
                                                    16).numpy(), atol=1e-12)


def test_coarsegrain_box_average(rng):
    x = rng.standard_normal((8, 8))
    y = top.coarsegrain(_port(x), 4).numpy()
    manual = x.reshape(4, 2, 4, 2).mean(axis=(1, 3))
    np.testing.assert_allclose(y, top.clean_2h(_port(manual)).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(y.mean(), x.mean(), atol=1e-12)


def test_fft_interpolate_roundtrip(rng):
    x = band_limited(rng, 32, kmax=10)
    back = top.fft_interpolate(top.fft_interpolate(_port(x), 32, 48), 48,
                               32).numpy()
    np.testing.assert_allclose(back, x, atol=1e-10)


def test_fft_interpolate_exact_on_harmonics():
    n, N, L = 32, 48, 1e6

    def xs(m):
        return np.meshgrid(np.arange(m) * L / m, np.arange(m) * L / m)

    x, y = xs(n)
    f = np.cos(3 * 2 * np.pi * x / L) * np.sin(5 * 2 * np.pi * y / L)
    X, Y = xs(N)
    expected = np.cos(3 * 2 * np.pi * X / L) * np.sin(5 * 2 * np.pi * Y / L)
    np.testing.assert_allclose(top.fft_interpolate(_port(f), n, N).numpy(),
                               expected, atol=1e-10)


def test_fft_interpolate_commutes_with_derivative(rng):
    n, N = 32, 48
    x = band_limited(rng, n, kmax=8)
    g, G = make_grid(n), make_grid(N)
    dx_then_up = top.fft_interpolate(_port(g.ifft(g.fft(x) * g.ik)), n, N)
    up_then_dx = G.ifft(G.fft(top.fft_interpolate(_port(x), n,
                                                  N).numpy()) * G.ik)
    np.testing.assert_allclose(dx_then_up.numpy(), up_then_dx, atol=1e-10)


def test_gauss_filter_transmission(rng):
    n = 64
    g = make_grid(n)
    x = rng.standard_normal((n, n))
    y = top.gauss_filter(_port(x), n // 2).numpy()
    xh, yh = np.fft.rfftn(x), np.fft.rfftn(y)
    expected = np.exp(-g.wv2 * (2 * g.dx) ** 2 / 24)
    mask = np.abs(xh) > 1e-12
    np.testing.assert_allclose((yh / xh)[mask].real, expected[mask],
                               atol=1e-7)


def test_operator_composites_shapes(rng):
    x = _port(rng.standard_normal((2, 128, 128)))
    for name, f in top.OPERATORS.items():
        y = f(x, 32).numpy()
        assert y.shape == (2, 32, 32), name
        assert np.isfinite(y).all(), name


def test_advect_dealias_consistency(rng):
    q, u, v = (_port(a) for a in band_limited(rng, 64, kmax=8, nfields=3))
    a0 = top.advect(q, u, v).numpy()
    a32 = top.advect(q, u, v, "3/2-rule").numpy()
    np.testing.assert_allclose(a0, a32, rtol=1e-7,
                               atol=1e-12 * np.abs(a0).max())


def test_pv_subgrid_forcing_identity_operator_is_zero(rng):
    p = TParams(nx=32, precision="double")
    q = np.stack(band_limited(rng, 32, kmax=5, nfields=2)) * 1e-5
    forcing, _ = top.PV_subgrid_forcing(_port(q), 32, lambda x, nc: x, p,
                                        "3/2-rule")
    assert float(forcing.abs().max()) < 1e-18


def test_pv_subgrid_forcing_shapes(rng):
    p = TParams(nx=64, precision="double")
    q = np.stack(band_limited(rng, 64, kmax=10, nfields=2)) * 1e-5
    forcing, rest = top.PV_subgrid_forcing(_port(q), 32, top.Operator2, p,
                                           "3/2-rule")
    for arr in (forcing,) + rest:
        assert arr.shape == (2, 32, 32)
        assert torch.isfinite(arr).all()


def test_gcm_filter_discrete_gaussian():
    n, nc = 64, 32
    X = _port(np.random.default_rng(0).normal(size=(2, n, n)))
    Y = top.gcm_filter(X, nc).numpy()
    np.testing.assert_allclose(Y.mean(axis=(-2, -1)),
                               X.numpy().mean(axis=(-2, -1)), atol=1e-12)
    g = make_grid(n)
    x = np.arange(n) * g.dx
    mode = _port(np.cos(2 * np.pi * x / g.L)[None, :] * np.ones((n, 1)))
    np.testing.assert_allclose(top.gcm_filter(mode[None], nc).numpy()[0],
                               top.gauss_filter(mode[None], nc).numpy()[0],
                               rtol=2e-3, atol=1e-6)
    nyq = _port(np.cos(np.pi * np.arange(n))[None, :] * np.ones((n, 1)))
    t_disc = float(top.gcm_filter(nyq[None], nc).abs().max())
    t_cont = float(top.gauss_filter(nyq[None], nc).abs().max())
    assert t_disc > t_cont
