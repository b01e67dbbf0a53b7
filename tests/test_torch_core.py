"""The port's QG core against its JAX twin (pyqg_generative_tpu.qg), on the
CPU. Inputs are made with numpy and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg.grid import make_grid as t_make_grid
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg.grid import make_grid as j_make_grid
from pyqg_generative_tpu.qg.params import QGParams as JParams

torch.set_num_threads(1)

GRID_ARRAYS = ("x", "y", "kk", "ll", "k", "l", "ik", "il", "wv2", "wv",
               "wv2i", "filtr", "wvx")


def test_grid_arrays_equal_jax():
    """The copied grid module gives the twin's arrays exactly."""
    for args in ((32,), (48, 32, 1e6, 5e5, 1e20)):
        tg, jg = t_make_grid(*args), j_make_grid(*args)
        for name in GRID_ARRAYS:
            np.testing.assert_array_equal(getattr(tg, name),
                                          getattr(jg, name), err_msg=name)
        assert (tg.dx, tg.dk, tg.M) == (jg.dx, jg.dk, jg.M)


def test_default_initial_q_bitwise():
    """Same numpy draws, same arithmetic: bitwise equal in both
    precisions."""
    for precision in ("single", "double"):
        tp, jp = TParams(nx=48, precision=precision), \
            JParams(nx=48, precision=precision)
        for seed in (0, 7):
            t = tcore.default_initial_q(tp, rng=np.random.default_rng(seed))
            j = jcore.default_initial_q(jp, rng=np.random.default_rng(seed))
            assert t.dtype == getattr(torch, str(np.asarray(j).dtype))
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _jax_run(jp, q0, n, forcing=None):
    step = jax.jit(jcore.step, static_argnums=1)
    st = jcore.init_state(jnp.asarray(q0), jp)
    f = None if forcing is None else jnp.asarray(forcing)
    for _ in range(n):
        st = step(st, jp, f)
    return st


def _two_members(p):
    return np.stack([tcore.default_initial_q(
        p, rng=np.random.default_rng(s)).numpy() for s in (7, 8)])


def test_twenty_steps_float64_match_jax():
    """20 steps of two batched members at 32^2 in float64 against the JAX
    core member by member. rtol 1e-9: the same float64 algebra, differing
    only in FFT summation order (mirrors tests/test_core.py:161)."""
    tp, jp = TParams(nx=32, precision="double"), \
        JParams(nx=32, precision="double")
    q0 = _two_members(tp)
    st = tcore.init_state(q0, tp, device="cpu")
    for _ in range(20):
        st = tcore.step(st, tp)
    assert (st.tc, st.t) == (20, 20 * tp.dt)
    q_t = tcore.irfft2(st.qh, 32, 32).numpy()
    for m in range(2):
        js = _jax_run(jp, q0[m], 20)
        q_j = np.fft.irfftn(np.asarray(js.qh), s=(32, 32), axes=(-2, -1))
        np.testing.assert_allclose(q_t[m], q_j, rtol=1e-9,
                                   atol=1e-12 * np.abs(q_j).max())


def test_twenty_steps_float32_match_jax():
    """The float32/complex64 path of the main run. Tolerance 1e-5 of the
    field's max: float32 rounding (6e-8) in FFTs of another summation order,
    accumulated over 20 steps."""
    tp, jp = TParams(nx=32, precision="single"), \
        JParams(nx=32, precision="single")
    q0 = _two_members(tp)
    st = tcore.init_state(q0, tp, device="cpu")
    for _ in range(20):
        st = tcore.step(st, tp)
    assert st.qh.dtype == torch.complex64
    flds = tcore.fields(st.qh, tp)
    assert flds.q.dtype == torch.float32
    for m in range(2):
        js = _jax_run(jp, q0[m], 20)
        jf = jcore.fields(js.qh, jp)
        for name in ("q", "u", "v"):
            ref = np.asarray(getattr(jf, name))
            np.testing.assert_allclose(getattr(flds, name)[m].numpy(), ref,
                                       rtol=0, atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)
        np.testing.assert_allclose(tcore.cfl(flds, tp)[m].item(),
                                   float(jcore.cfl(jf, jp)), rtol=1e-4)
        np.testing.assert_allclose(tcore.total_ke(flds, tp)[m].item(),
                                   float(jcore.total_ke(jf, jp)), rtol=1e-4)


def test_forcing_hook_matches_jax():
    """The forcing hook: the first (Euler) step responds with dt*filtr*F
    (mirrors tests/test_core.py:242), and the forced step equals the twin's
    at rtol 1e-10 in float64."""
    rng = np.random.default_rng(3)
    tp, jp = TParams(nx=32, precision="double"), \
        JParams(nx=32, precision="double")
    q0 = tcore.default_initial_q(tp, rng=rng).numpy()
    forcing = rng.standard_normal((2, 32, 32)) * 1e-12
    st = tcore.init_state(q0, tp, device="cpu")
    s1 = tcore.step(st, tp)
    s2 = tcore.step(st, tp, forcing=torch.from_numpy(forcing))
    dq = (s2.qh - s1.qh).numpy()
    fh = np.fft.rfftn(forcing, axes=(-2, -1))
    np.testing.assert_allclose(dq, tp.dt * t_make_grid(32).filtr * fh,
                               rtol=1e-10, atol=1e-10 * np.abs(dq).max())
    js = _jax_run(jp, q0, 1, forcing)
    ref = np.asarray(js.qh)
    np.testing.assert_allclose(s2.qh.numpy(), ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())
