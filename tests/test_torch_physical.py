"""The port's physical closures (`pyqg_generative_torch/models/physical.py`)
against their JAX twins, on the CPU: the forcing amplitudes pinned by
tests/test_physical_regression.py on the stored equilibrated 48^2 snapshot
(float32, rel 1e-3); each closure's forcing against the twin's in float64
(rtol 1e-10, atol 1e-12 of max|ref|: two FFT libraries rounding at float64),
for one member and for a batch of two; and a 10-step online run against the
twin's online step."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqg_generative_torch.models import physical as tph
from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim.simulate import init_run_carry, \
    make_online_step
from pyqg_generative_tpu.models import physical as jph
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim
from pyqg_generative_tpu.sim import stochastic as jsto

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "eddy48_snapshot.npz")
# the golden stds of tests/test_physical_regression.py:27-35
GOLDEN = {
    "ZannaBolton2020": 2.565353e-12,
    "Smagorinsky": 4.222914e-13,
    "BackscatterEddy": 1.028523e-12,
    "BackscatterJet": 7.651830e-13,
    "ADM": 2.588906e-12,
    "ReynoldsStress": 8.307134e-13,
    "HybridSymbolic": 2.665697e-12,
}
# every closure the twin has, by name, with the arguments of a case
CLOSURES = {
    "ZannaBolton2020": {}, "Smagorinsky": {}, "BackscatterBiharmonic": {},
    "BackscatterEddy": {}, "BackscatterJet": {}, "ADM": {},
    "ReynoldsStress": {}, "HybridSymbolic": {},
    "Laplace": {"nu": 1e3}, "Laplace_PV": {"nu": 1e3, "PV": True},
    "BackscatterBiharmonicEddy": {}, "BackscatterBiharmonicJet": {},
}


def _make(module, name, **kw):
    return getattr(module, name.split("_")[0])(**CLOSURES[name], **kw)


@pytest.fixture(scope="module")
def snapshot():
    q = np.load(DATA)["q"]
    assert q.shape == (2, 48, 48) and q.dtype == np.float32
    return q


@pytest.mark.parametrize("name,expected", sorted(GOLDEN.items()))
def test_forcing_amplitude_pinned(snapshot, name, expected):
    """The port's forcing on the snapshot, float32, as the twin's pin."""
    p = TParams(nx=48, precision="single")
    f = _make(tph, name, device="cpu").predict_snapshot(
        torch.from_numpy(snapshot), p=p)
    assert f.shape == (2, 48, 48) and f.dtype == torch.float32
    assert torch.isfinite(f).all()
    assert float(np.std(f.numpy())) == pytest.approx(expected, rel=1e-3)


@pytest.fixture(scope="module")
def members(snapshot):
    """Two members, float64: the snapshot and the snapshot rolled by a
    quarter of the domain and scaled by 1.5 (a different energy budget)."""
    q = snapshot.astype(np.float64)
    return np.stack([q, 1.5 * np.roll(q, 12, axis=(-2, -1))])


@pytest.mark.parametrize("name", sorted(CLOSURES))
def test_closure_matches_twin_float64(members, name):
    """In float64, one member and a batch of two (the twin vmaps members;
    the port sums the backscatter's budget over each member's levels and
    grid alone), against the twin on each member."""
    tp, jp = TParams(nx=48, precision="double"), \
        JParams(nx=48, precision="double")
    port = _make(tph, name, device="cpu")
    twin = _make(jph, name)
    ref = np.stack([np.asarray(twin.predict_snapshot(jnp.asarray(m), p=jp))
                    for m in members])
    batch = port.predict_snapshot(torch.from_numpy(members), p=tp).numpy()
    one = port.predict_snapshot(torch.from_numpy(members[1]), p=tp).numpy()
    assert batch.dtype == np.float64 and np.abs(ref).max() > 0
    for out, r in ((batch, ref), (one, ref[1])):
        np.testing.assert_allclose(out, r, rtol=1e-10,
                                   atol=1e-12 * np.abs(r).max())


def test_registry_and_online_hooks(members):
    """Every physical closure the twin registers is registered by the port,
    takes `device`, and removes each member's spatial mean online."""
    names = {n for n, c in jph.__dict__.items() if isinstance(c, type)
             and issubclass(c, jph.PhysicalParameterization)
             and c is not jph.PhysicalParameterization}
    port = {n for n, c in tph.__dict__.items() if isinstance(c, type)
            and issubclass(c, tph.PhysicalParameterization)
            and c is not tph.PhysicalParameterization}
    assert names == port
    p = TParams(nx=48, precision="double")
    flds = tcore.fields(tcore.init_state(members, p, device="cpu").qh, p)
    model = tph.BackscatterEddy(device="cpu")
    f = model.online_forcing(flds, None, p)
    assert f.shape == (2, 2, 48, 48)
    assert float(f.mean(dim=(-2, -1)).abs().max()) < 1e-25
    assert torch.equal(model.online_mean_forcing(flds, p), f)


def test_backscatter_online_run_matches_twin():
    """A 10-step online run of BackscatterEddy, 2 members x 32^2 in float64,
    against the twin's online step vmapped over the members; rtol 1e-10 /
    atol 1e-12 of max|q| after the 10 steps."""
    kw = dict(nx=32, dt=14400.0, tavestart=0.0, taveint=2 * 14400.0,
              precision="double")
    tp, jp = TParams(**kw), JParams(**kw)
    q0 = np.stack([1e3 * tcore.default_initial_q(
        tp, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    twin = jph.BackscatterEddy()
    jstep = jax.jit(jax.vmap(jsim.make_online_step(jp, twin, "AR1", 1,
                                                   with_diags=False)))
    carry = jax.vmap(lambda q: (
        jcore.init_state(q, jp),
        jsto.SamplerState(noise=jnp.zeros((32, 32, 0)),
                          forcing=jnp.zeros((2, 32, 32), jnp.float64),
                          counter=jnp.zeros((), jnp.int32),
                          key=jax.random.PRNGKey(0)), None))(jnp.asarray(q0))
    for _ in range(10):
        carry = jstep(carry)
    model = tph.BackscatterEddy(device="cpu")
    tstep = make_online_step(tp, model, "AR1", 1, with_diags=False)
    tcarry = init_run_carry(tp, q0, 0, model, with_diags=False,
                            device="cpu")
    for _ in range(10):
        tcarry = tstep(tcarry)
    q_t = tcore.fields(tcarry[0].qh, tp).q.numpy()
    q_j = np.stack([np.asarray(jcore.fields(carry[0].qh[m], jp).q)
                    for m in range(2)])
    np.testing.assert_allclose(q_t, q_j, rtol=1e-10,
                               atol=1e-12 * np.abs(q_j).max())
    np.testing.assert_allclose(tcarry[1].forcing.numpy(),
                               np.asarray(carry[1].forcing), rtol=1e-10,
                               atol=1e-12 * np.abs(carry[1].forcing).max())
