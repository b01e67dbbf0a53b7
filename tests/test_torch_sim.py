"""The port's samplers, GAN closure and online step against the JAX twin,
on the CPU. Torch cannot reproduce JAX's threefry draws, so parity runs hand
both packages the same numpy noise and freeze the sampler (AR1, nsteps<0);
sampled noise is checked by its statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pyqg_generative_torch.models import load_model
from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg import diagnostics as tdiag
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim import stochastic as tsto
from pyqg_generative_torch.sim.simulate import init_run_carry, \
    make_online_step
from pyqg_generative_tpu.ml.scalers import ChannelwiseScaler
from pyqg_generative_tpu.models.cgan_regression import CGANRegression
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg import diagnostics as jdiag
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim
from pyqg_generative_tpu.sim import stochastic as jsto

torch.set_num_threads(1)

FOLDER = "trained_models/eddy_gan_64"


@pytest.fixture(scope="module")
def jax_gan():
    """The twin's eddy_gan_64 on its flax path (online_backend="xla").
    Built from a missing folder and handed the weights, which skips the
    flax template init of load_model (the same file, read by flax)."""
    m = CGANRegression(folder="/nonexistent_model_folder")
    with open(f"{FOLDER}/G.msgpack", "rb") as f:
        m.vars_G = serialization.msgpack_restore(f.read())
    m.x_scale = ChannelwiseScaler().read("x_scale.json", FOLDER)
    m.y_scale = ChannelwiseScaler().read("y_scale.json", FOLDER)
    return m


@pytest.fixture(scope="module")
def torch_gan():
    return load_model(FOLDER, device="cpu")


class _Latent:
    """A closure with two latent channels, for sampler tests."""

    def generate_latent_noise(self, generator, ny, nx, batch_shape=()):
        return torch.randn(tuple(batch_shape) + (ny, nx, 2),
                           generator=generator, dtype=torch.float64)


def test_frozen_sampler_matches_twin():
    """Frozen AR1 with injected noise: both packages keep the noise and
    hand it to the closure every step; counters advance alike. Exact."""
    noise = np.random.default_rng(0).standard_normal((8, 8, 2))
    js = jsto.SamplerState(noise=jnp.asarray(noise),
                           forcing=jnp.zeros((2, 8, 8)),
                           counter=jnp.zeros((), jnp.int32),
                           key=jax.random.PRNGKey(0))
    ts = tsto.SamplerState(noise=torch.from_numpy(noise),
                           forcing=torch.zeros(2, 8, 8, dtype=torch.float64),
                           counter=0, generator=torch.Generator())

    def j_compute(z):
        return 2.0 * jnp.moveaxis(z, -1, 0)

    def t_compute(z):
        return 2.0 * z.movedim(-1, 0)

    for _ in range(3):
        jf, js = jsto.sample_forcing(None, j_compute, js, "AR1", -1)
        tf, ts = tsto.sample_forcing(None, t_compute, ts, "AR1", -1)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.noise.numpy(), noise)
    assert ts.counter == int(js.counter) == 3


def test_ar1_sampler_statistics():
    """AR1(n=10): lag-1 autocorrelation ~ a = 1 - 1/n and unit variance
    (mirrors tests/test_sim.py:129), for a batch of 4 members."""
    st = tsto.init_sampler(0, _Latent(), 8, 8, torch.float64,
                           batch_shape=(4,), device="cpu")
    xs = [st.noise]
    for _ in range(200):
        _, st = tsto.sample_forcing(None, lambda z: torch.zeros(4, 2, 8, 8),
                                    st, "AR1", 10)
        xs.append(st.noise)
    xs = torch.stack(xs).reshape(201, -1).numpy()
    rho = np.corrcoef(xs[:-1].ravel(), xs[1:].ravel())[0, 1]
    assert abs(rho - 0.9) < 0.05
    assert abs(xs.std() - 1.0) < 0.1


def test_constant_sampler_skips_closure():
    """constant(3): the closure runs at steps 0 and 3 only, its forcing is
    reused in between (mirrors tests/test_sim.py:160)."""
    st = tsto.init_sampler(1, _Latent(), 8, 8, torch.float64, device="cpu")
    calls = []

    def compute(z):
        calls.append(1)
        return torch.full((2, 8, 8), float(z.sum()), dtype=torch.float64)

    fs = []
    for _ in range(6):
        f, st = tsto.sample_forcing(None, compute, st, "constant", 3)
        fs.append(float(f[0, 0, 0]))
    assert len(calls) == 2
    assert fs[0] == fs[1] == fs[2] != fs[3] == fs[4] == fs[5]


@pytest.mark.parametrize("variant", ["dx", "tap"])
def test_predict_snapshot_matches_twin(jax_gan, torch_gan, variant):
    """eddy_gan_64 at 16^2 against the twin's flax path, per member and
    batched, through K1's wrapper (its plain version on the CPU) under both
    of the twin's float32 variant names. rtol 2e-4, atol 2e-5*max: float32
    convolutions summed in another order."""
    rng = np.random.default_rng(4)
    q = (1e-5 * rng.standard_normal((2, 2, 16, 16))).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    ref = np.stack([np.asarray(jax_gan.predict_snapshot(
        jnp.asarray(q[m]), jnp.asarray(z[m]))) for m in range(2)])
    torch_gan.online_variant, torch_gan._online_cache = variant, None
    out = torch_gan.predict_snapshot(torch.from_numpy(q), torch.from_numpy(z))
    single = torch_gan.predict_snapshot(torch.from_numpy(q[1]),
                                        torch.from_numpy(z[1]))
    for a, b in ((out.numpy(), ref), (single.numpy(), ref[1])):
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=2e-5 * np.abs(b).max())


def test_mean_snapshot_matches_twin_generate(jax_gan, torch_gan):
    """predict_mean_snapshot (the deterministic sampler's closure) averages
    the unfolded generator over M latent draws: with the port's draws handed
    to the twin's `generate`, the means agree at rtol 2e-4 (float32
    convolutions summed in another order)."""
    rng = np.random.default_rng(6)
    q = (1e-5 * rng.standard_normal((2, 16, 16))).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    zs = [torch.randn((1, 16, 16, 2), generator=gen).numpy()
          for _ in range(2)]
    x = np.moveaxis(q, 0, -1)[None] / jax_gan.x_scale.std
    ref = sum(np.asarray(jax_gan.generate(x, z)) for z in zs) / 2
    ref = np.moveaxis((ref * jax_gan.y_scale.std)[0], -1, 0)
    out = torch_gan.predict_mean_snapshot(
        torch.from_numpy(q), M=2, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


def test_online_ensemble_matches_twin(jax_gan, torch_gan):
    """The slice as a whole: 2 members x 32^2, 10 steps of the GAN-closure
    online step with frozen injected noise and diagnostics on, in float32,
    against the twin's make_online_step. Tolerances: the closure differs by
    float32 convolution rounding and the solver by float32 FFT rounding. After
    10 steps the trajectories differ by 1.6e-6 of their max (the closure
    moves them by 2e-2), the diagnostics by at most 5e-5 of each key's max:
    the bounds 2e-5 and 5e-4 keep a tenfold margin."""
    kw = dict(nx=32, dt=14400.0, tavestart=0.0, taveint=2 * 14400.0,
              precision="single")
    tp, jp = TParams(**kw), JParams(**kw)
    rng = np.random.default_rng(5)
    q0 = np.stack([tcore.default_initial_q(
        tp, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    noise = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)

    jstep = jax.jit(jax.vmap(jsim.make_online_step(jp, jax_gan, "AR1", -1)))
    carry = jax.vmap(lambda q, z: (
        jcore.init_state(q, jp),
        jsto.SamplerState(noise=z, forcing=jnp.zeros((2, 32, 32),
                                                     jnp.float32),
                          counter=jnp.zeros((), jnp.int32),
                          key=jax.random.PRNGKey(0)),
        jdiag.init_diags(jp, True)))(jnp.asarray(q0), jnp.asarray(noise))
    for _ in range(10):
        carry = jstep(carry)

    tstep = make_online_step(tp, torch_gan, "AR1", -1)
    tcarry = init_run_carry(tp, q0, 0, torch_gan, device="cpu")
    tcarry[1].noise = torch.from_numpy(noise)
    for _ in range(10):
        tcarry = tstep(tcarry)

    q_t = tcore.fields(tcarry[0].qh, tp).q.numpy()
    for m in range(2):
        q_j = np.asarray(jcore.fields(carry[0].qh[m], jp).q)
        np.testing.assert_allclose(q_t[m], q_j, rtol=0,
                                   atol=2e-5 * np.abs(q_j).max())
    assert tcarry[2].count == 5.0
    np.testing.assert_array_equal(np.asarray(carry[2].count), [5.0, 5.0])
    d_j = jax.vmap(jdiag.finalize)(carry[2])
    d_t = tdiag.finalize(tcarry[2])
    assert sorted(d_t) == sorted(d_j) == sorted(jdiag.DIAG_KEYS)
    for k in d_j:
        ref = np.asarray(d_j[k])
        np.testing.assert_allclose(d_t[k].numpy(), ref, rtol=0,
                                   atol=5e-4 * np.abs(ref).max(), err_msg=k)
