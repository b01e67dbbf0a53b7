"""The port's GZ (MeanVarModel) and VAE (CVAERegression) closures against
their JAX twins' flax path (online_backend="xla"), on the CPU, with the
shipped weights of the models that the port's online paths run: given the
same q and noise, the forcing agrees per variant, and a frozen-noise online
run of the GZ model follows the twin's. The twins are built from a missing
folder and handed flax's own reading of the weights, which skips their
flax template init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pyqg_generative_torch.models import CVAERegression, MeanVarModel, \
    load_model
from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim.simulate import init_run_carry, \
    make_online_step
from pyqg_generative_tpu.ml.scalers import ChannelwiseScaler
from pyqg_generative_tpu.models import cgan_regression as jgan
from pyqg_generative_tpu.models import cvae_regression as jvae
from pyqg_generative_tpu.models import mean_var_model as jgz
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim
from pyqg_generative_tpu.sim import stochastic as jsto

torch.set_num_threads(1)

GZ = "trained_models/r4_eddy_gz_64_op1_s0"
VAE = "trained_models/r4_eddy_vae_64_op1_s0"
GAN = "trained_models/eddy_gan_64"


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _scalers(model, folder):
    model.x_scale = ChannelwiseScaler().read("x_scale.json", folder)
    model.y_scale = ChannelwiseScaler().read("y_scale.json", folder)
    return model


@pytest.fixture(scope="module")
def jax_gz():
    m = jgz.MeanVarModel(folder="/nonexistent_model_folder")
    m.vars_mean = _restore(f"{GZ}/net_mean.msgpack")
    m.vars_var = _restore(f"{GZ}/net_var.msgpack")
    return _scalers(m, GZ)


@pytest.fixture(scope="module")
def jax_vae():
    m = jvae.CVAERegression(folder="/nonexistent_model_folder")
    m.vars_dec = _restore(f"{VAE}/decoder.msgpack")
    return _scalers(m, VAE)


@pytest.fixture(scope="module")
def inputs():
    """q (2 members, 2 layers, 16^2) and latent noise, from numpy."""
    rng = np.random.default_rng(7)
    q = (1e-5 * rng.standard_normal((2, 2, 16, 16))).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    return q, z


def _twin(model, q, z):
    return np.stack([np.asarray(model.predict_snapshot(
        jnp.asarray(q[m]), jnp.asarray(z[m]))) for m in range(len(q))])


def _close(out, ref):
    """rtol 2e-4, atol 2e-5*max: float32 convolutions summed in another
    order (the bar of tests/test_pallas_conv.py:49)."""
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def gz_ref(jax_gz, inputs):
    return _twin(jax_gz, *inputs)


@pytest.mark.parametrize("variant", ["dx", "dxpair"])
def test_gz_predict_snapshot_matches_twin(gz_ref, inputs, variant):
    """Two kernel calls ("dx") or one on the merged pair ("dxpair"), in
    float32, batched and single member, against the twin's two unfolded
    flax nets with their softplus head."""
    q, z = inputs
    model = load_model(GZ, device="cpu", online_variant=variant)
    assert isinstance(model, MeanVarModel)
    out = model.predict_snapshot(torch.from_numpy(q), torch.from_numpy(z))
    single = model.predict_snapshot(torch.from_numpy(q[1]),
                                    torch.from_numpy(z[1]))
    assert len(model._online_fns()) == (1 if variant == "dxpair" else 2)
    _close(out.numpy(), gz_ref)
    _close(single.numpy(), gz_ref[1])


@pytest.fixture(scope="module")
def jax_gan():
    m = jgan.CGANRegression(folder="/nonexistent_model_folder")
    m.vars_G = _restore(f"{GAN}/G.msgpack")
    return _scalers(m, GAN)


@pytest.mark.parametrize("closure", ["gz", "gan"])
def test_bf16_close_to_twin_f32(request, inputs, closure):
    """bf16 inference (Conv_0 in float32, the chain on bf16 inputs through
    K1's wrapper) against the twin's float32 flax path: GZ with path 2's
    "dxbpair", and the GAN, whose main path now also takes bf16. Relative
    RMS < 2% (the bf16 bar of tests/test_pallas_conv.py:65-76)."""
    q, z = inputs
    if closure == "gz":
        ref, folder, variant = request.getfixturevalue("gz_ref"), GZ, \
            "dxbpair"
    else:
        ref = _twin(request.getfixturevalue("jax_gan"), q, z)
        folder, variant = GAN, "dx"
    model = load_model(folder, device="cpu", online_variant=variant,
                       inference_dtype="bfloat16")
    out = model.predict_snapshot(torch.from_numpy(q),
                                 torch.from_numpy(z)).numpy()
    rel = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
    assert rel < 2e-2


def test_gz_mean_and_var_nets_match_twin(jax_gz, inputs):
    """The unfolded nets: predict_mean_snapshot (the deterministic
    sampler's closure) and the VarCNN with its softplus head against the
    twin's, rtol 2e-4 / atol 2e-5*max."""
    q, _ = inputs
    model = load_model(GZ, device="cpu")
    ref = np.asarray(jax_gz.predict_mean_snapshot(jnp.asarray(q[0])))
    _close(model.predict_mean_snapshot(torch.from_numpy(q[0])).numpy(), ref)
    x = np.moveaxis(q[:1], 1, -1) / jax_gz.x_scale.std
    var_ref = np.asarray(jax_gz._apply_var(jnp.asarray(x)))
    with torch.no_grad():
        var = model.net_var(torch.from_numpy(x.astype(np.float32))).numpy()
    assert (var >= 0).all()
    _close(var, var_ref)


@pytest.mark.parametrize("variant", ["dx", "packed"])
def test_vae_predict_snapshot_matches_twin(jax_vae, inputs, variant):
    """The decoder through K1's wrapper ("dx") or K2's ("packed"), float32,
    batched and single member, against the twin's unfolded flax decoder."""
    q, z = inputs
    ref = _twin(jax_vae, q, z)
    model = load_model(VAE, device="cpu", online_variant=variant)
    assert isinstance(model, CVAERegression)
    out = model.predict_snapshot(torch.from_numpy(q), torch.from_numpy(z))
    single = model.predict_snapshot(torch.from_numpy(q[0]),
                                    torch.from_numpy(z[0]))
    _close(out.numpy(), ref)
    _close(single.numpy(), ref[0])


def test_vae_mean_snapshot_matches_twin_generate(jax_vae, inputs):
    """predict_mean_snapshot (the deterministic sampler's closure) averages
    the decoder over M latent draws, as the twin's does with the GAN's
    machinery: with the port's draws handed to the twin's `generate`, the
    means agree at rtol 2e-4 / atol 2e-5*max (float32 convolutions summed
    in another order)."""
    q = inputs[0][0]
    gen = torch.Generator().manual_seed(0)
    zs = [torch.randn((1, 16, 16, 2), generator=gen).numpy()
          for _ in range(2)]
    x = np.moveaxis(q, 0, -1)[None] / jax_vae.x_scale.std
    ref = sum(np.asarray(jax_vae.generate(x, z)) for z in zs) / 2
    ref = np.moveaxis((ref * jax_vae.y_scale.std)[0], -1, 0)
    out = load_model(VAE, device="cpu", online_variant="packed") \
        .predict_mean_snapshot(torch.from_numpy(q), M=2,
                               generator=torch.Generator().manual_seed(0))
    _close(out.numpy(), ref)


def test_gz_online_run_matches_twin(jax_gz):
    """A frozen-noise online run of the GZ model ("dxpair", float32): 2
    members x 32^2, 6 steps, against the twin's make_online_step. The
    closure differs by float32 convolution rounding and the solver by
    float32 FFT rounding: the bound is that of the GAN run in
    tests/test_torch_sim.py, 2e-5 of max|q|. The diagnostics, which do not
    depend on the closure's family, are held there."""
    kw = dict(nx=32, dt=14400.0, tavestart=0.0, taveint=2 * 14400.0,
              precision="single")
    tp, jp = TParams(**kw), JParams(**kw)
    q0 = np.stack([tcore.default_initial_q(
        tp, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    noise = np.random.default_rng(8).standard_normal(
        (2, 32, 32, 2)).astype(np.float32)

    jstep = jax.jit(jax.vmap(jsim.make_online_step(jp, jax_gz, "AR1", -1,
                                                   with_diags=False)))
    carry = jax.vmap(lambda q, z: (
        jcore.init_state(q, jp),
        jsto.SamplerState(noise=z, forcing=jnp.zeros((2, 32, 32),
                                                     jnp.float32),
                          counter=jnp.zeros((), jnp.int32),
                          key=jax.random.PRNGKey(0)),
        None))(jnp.asarray(q0), jnp.asarray(noise))
    for _ in range(6):
        carry = jstep(carry)

    model = load_model(GZ, device="cpu", online_variant="dxpair")
    tstep = make_online_step(tp, model, "AR1", -1, with_diags=False)
    tcarry = init_run_carry(tp, q0, 0, model, with_diags=False,
                            device="cpu")
    tcarry[1].noise = torch.from_numpy(noise)
    for _ in range(6):
        tcarry = tstep(tcarry)

    q_t = tcore.fields(tcarry[0].qh, tp).q.numpy()
    for m in range(2):
        q_j = np.asarray(jcore.fields(carry[0].qh[m], jp).q)
        np.testing.assert_allclose(q_t[m], q_j, rtol=0,
                                   atol=2e-5 * np.abs(q_j).max())
