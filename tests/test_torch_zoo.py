"""The rest of the twin's closures in the port, against their JAX twins on
the CPU: checkpoint selection on the shipped GAN and VAE folders, the
divergence head (GAN and VAE, against the twin's default "xla" path), OLS,
ANN, the DeepInversion generator and the bottleneck VAE; the new nets
against flax; and the weights both ways (`params_to_jax`, flax msgpack
written with `msgpack` alone and read back by flax).

Random weights are flax trees of the port's module layouts filled from a
seeded numpy generator (`ml.weights.seeded_variables`): no flax `init`.
The twins are built from a missing folder and handed the trees. Networks
are held at rtol 2e-4 / atol 2e-5*max|ref| (float32 convolutions summed in
another order, the bar of tests/test_pallas_conv.py:49)."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml.weights import params_from_jax, \
    params_to_jax, read_msgpack, seeded_variables, to_msgpack_bytes
from pyqg_generative_torch.models import MODEL_REGISTRY, ANNModel, \
    CGANRegression, CVAEBottleneck, CVAERegression, OLSModel, load_model, \
    save_model_args, save_variables
from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim.simulate import init_run_carry, \
    make_online_step
from pyqg_generative_tpu.ml import nets as jnets
from pyqg_generative_tpu.ml.scalers import ChannelwiseScaler
from pyqg_generative_tpu.models import ann_model as jann
from pyqg_generative_tpu.models import base as jbase
from pyqg_generative_tpu.models import cgan_regression as jgan
from pyqg_generative_tpu.models import cvae_bottleneck as jbot
from pyqg_generative_tpu.models import cvae_regression as jvae
from pyqg_generative_tpu.models import ols_model as jols
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim
from pyqg_generative_tpu.sim import stochastic as jsto

torch.set_num_threads(1)

MODELS = "trained_models"
SCALERS = f"{MODELS}/eddy_gan_64"
MISSING = "/nonexistent_model_folder"


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _scalers(model, folder):
    model.x_scale = ChannelwiseScaler().read("x_scale.json", folder)
    model.y_scale = ChannelwiseScaler().read("y_scale.json", folder)
    return model


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


def _inputs(nx, seed, latent=None):
    """q (2 members, 2 layers, nx^2) at an eddy amplitude and latent noise,
    a member's (nx, nx, 2) unless `latent` is given, float32."""
    rng = np.random.default_rng(seed)
    q = (1e-5 * rng.standard_normal((2, 2, nx, nx))).astype(np.float32)
    z = rng.standard_normal((2,) + (latent or (nx, nx, 2))).astype(
        np.float32)
    return q, z


def _twin(model, q, z=None):
    """The twin's predict_snapshot, jitted and vmapped over the members."""
    if z is None:
        return np.asarray(jax.jit(jax.vmap(model.predict_snapshot))(
            jnp.asarray(q)))
    return np.asarray(jax.jit(jax.vmap(model.predict_snapshot))(
        jnp.asarray(q), jnp.asarray(z)))


def _port(model, q, z=None):
    q = torch.from_numpy(q)
    return model.predict_snapshot(q) if z is None else \
        model.predict_snapshot(q, torch.from_numpy(z))


def _write_folder(path, name, nets, scale=True, **args):
    """A model folder of the twin's contract, written by the port:
    `model_args.json`, one flax msgpack file a net, the GAN's scalers."""
    for fname, tree in nets.items():
        save_variables(tree, str(path / f"{fname}.msgpack"))
    if scale:
        for s in ("x_scale.json", "y_scale.json"):
            shutil.copy(f"{SCALERS}/{s}", path / s)
    save_model_args(name, folder=str(path), **args)
    return str(path)


# ----------------------------------------------------------- checkpoints

SWITCHES = {
    "gan_opt": (f"{MODELS}/r4_eddy_gan_64_op1_s0", "use_optimal_epoch",
                "G", "G_opt", {}),
    "gan_stable": (f"{MODELS}/eddy_gan_48_op1_stable", "use_stable_epoch",
                   "G", "G_stable", {}),
    "vae_opt": (f"{MODELS}/r4_eddy_vae_64_op1_s0", "use_optimal_epoch",
                "decoder", "decoder_opt", {"online_variant": "packed"}),
}


@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_checkpoint_switch_matches_twin(case):
    """Before the switch the port's forcing is the twin's on the folder's
    last weights; after it, the twin's on the selected epoch's, and a
    different one: the packed kernel weights were dropped and the weights
    generation grew. A 16^2 crop of the input."""
    folder, switch, last, chosen, kw = SWITCHES[case]
    q, z = _inputs(16, 3)
    vae = case.startswith("vae")
    twin = (jvae.CVAERegression if vae else jgan.CGANRegression)(
        folder=MISSING)
    _scalers(twin, folder)
    model = load_model(folder, device="cpu", **kw)
    before = _port(model, q, z)
    packed = (model._online_dec if vae else model._online_cnn)().packed
    generation = model.weights_generation
    for fname, out in ((last, before), (chosen, None)):
        tree = _restore(f"{folder}/{fname}.msgpack")
        if vae:
            twin.vars_dec = tree
        else:
            twin.vars_G = tree
        if out is None:
            assert getattr(model, switch)() is True
            assert model._online_cache is None
            assert model.weights_generation == generation + 1
            out = _port(model, q, z)
        _close(out, _twin(twin, q, z))
    assert (model._online_dec if vae else model._online_cnn)().packed \
        is not packed
    assert float((out - before).abs().max()) > 1e-3 * float(
        before.abs().max())


def test_missing_checkpoint_leaves_weights():
    """A switch to an epoch the folder does not hold returns False and keeps
    the weights, their packing and the generation."""
    model = load_model(f"{MODELS}/r4_eddy_gan_64_op1_s0", device="cpu")
    cnn, generation = model._online_cnn(), model.weights_generation
    assert model.use_stable_epoch() is False
    assert model._online_cnn() is cnn
    assert model.weights_generation == generation


# ------------------------------------------------------- the divergence head

def _andrew_tree(n_in, div, seed, **kw):
    return seeded_variables(tnets.AndrewCNN(n_in, 2, div=div, **kw), seed)


@pytest.fixture(scope="module")
def div_folders(tmp_path_factory):
    """A div=True GAN with a mean net (regression "full_loss") and a
    div=True VAE, on seeded weights at the published widths."""
    root = tmp_path_factory.mktemp("div")
    g, m, d = (_andrew_tree(4, True, 40), _andrew_tree(2, True, 41),
               _andrew_tree(4, True, 42))
    (root / "gan").mkdir()
    (root / "vae").mkdir()
    gan = _write_folder(root / "gan", "CGANRegression",
                        {"G": g, "net_mean": m}, regression="full_loss",
                        nx=16, generator="Andrew", div=True)
    vae = _write_folder(root / "vae", "CVAERegression", {"decoder": d},
                        regression="None", div=True)
    return {"gan": (gan, g, m), "vae": (vae, d, None)}


@pytest.mark.parametrize("case,variant", [("gan", "dx"), ("vae", "dx"),
                                          ("vae", "packed")])
def test_divergence_head_matches_twin(div_folders, case, variant):
    """The chain (4 output channels) through K1's or K2's wrapper, then
    10000 * its spectral divergence in float32, against the twin's "xla"
    path (its flax net with the head inside)."""
    folder, tree, mean = div_folders[case]
    q, z = _inputs(16, 4)
    if case == "gan":
        twin = jgan.CGANRegression(folder=MISSING, div=True,
                                   regression="full_loss")
        twin.vars_G, twin.vars_mean = tree, mean
    else:
        twin = jvae.CVAERegression(folder=MISSING, div=True)
        twin.vars_dec = tree
    _scalers(twin, SCALERS)
    model = load_model(folder, device="cpu", online_variant=variant)
    online = (model._online_cnn if case == "gan" else model._online_dec)()
    assert online.packed.meta[-1][2] == 4
    out = _port(model, q, z)
    _close(out, _twin(twin, q, z))
    _close(model.predict_snapshot(torch.from_numpy(q[1]),
                                  torch.from_numpy(z[1])), out[1])


def test_spectral_divergence_matches_twin():
    """The head alone, float32 NHWC with a member axis."""
    x = np.random.default_rng(5).standard_normal((2, 16, 24, 6)).astype(
        np.float32)
    out = tnets.spectral_divergence(torch.from_numpy(x))
    ref = np.asarray(jnets.spectral_divergence(jnp.asarray(x)))
    assert out.shape == (2, 16, 24, 3)
    _close(out, ref)


# ------------------------------------------------------------ OLS and ANN

OLS = {"bn": {}, "no_bn_softplus": dict(batch_norm=False, bias=False,
                                        final_activation="softplus"),
       "div": dict(div=True)}


@pytest.mark.parametrize("case", sorted(OLS))
def test_ols_matches_twin(case, tmp_path):
    """OLS (an AndrewCNN with its options) through cuDNN's plain version on
    the CPU, against the twin's flax path."""
    kw = OLS[case]
    tree = seeded_variables(tnets.AndrewCNN(2, 2, **kw), 50)
    folder = _write_folder(tmp_path, "OLSModel", {"net": tree}, **kw)
    model = load_model(folder, device="cpu")
    assert isinstance(model, OLSModel)
    twin = _scalers(jols.OLSModel(folder=MISSING, **kw), SCALERS)
    twin.variables = tree
    q, _ = _inputs(16, 6)
    _close(_port(model, q), _twin(twin, q))


def test_ann_eddy_jet_matches_twin():
    """The shipped stencil MLP, its scalars from scale.json."""
    folder = f"{MODELS}/ann_eddy_jet"
    model = load_model(folder, device="cpu")
    assert isinstance(model, ANNModel)
    twin = jann.ANNModel(folder=MISSING, read=False)
    twin.variables = _restore(f"{folder}/net.msgpack")
    with open(f"{folder}/scale.json") as f:
        scale = json.load(f)
    twin.x_scale, twin.y_scale = scale["x_scale"], scale["y_scale"]
    q, _ = _inputs(32, 7)
    _close(_port(model, q), _twin(twin, q))
    _close(model.predict_snapshot(torch.from_numpy(q[0])),
           np.asarray(twin.predict_snapshot(jnp.asarray(q[0]))))


def test_scale_invariant_ann_matches_twin(tmp_path):
    """The scale-invariant form norm^2 f(x / norm), on seeded weights."""
    tree = seeded_variables(tnets.ANN(9, 1, degree=2), 51)
    save_variables(tree, str(tmp_path / "net.msgpack"))
    with open(tmp_path / "scale.json", "w") as f:
        json.dump({"x_scale": 5e-6, "y_scale": 1.5e-12}, f)
    save_model_args("ANNModel", folder=str(tmp_path), stencil_size=3,
                    hidden_channels=[24, 24], scale_invariant=True)
    model = load_model(str(tmp_path), device="cpu")
    twin = jann.ANNModel(folder=MISSING, read=False, scale_invariant=True)
    twin.variables, twin.x_scale, twin.y_scale = tree, 5e-6, 1.5e-12
    q, _ = _inputs(16, 8)
    _close(_port(model, q), _twin(twin, q))


# ------------------------------------------ DeepInversion and the bottleneck

def test_deep_inversion_gan_matches_twin(tmp_path):
    """CGANRegression(generator="DeepInversion") at 32^2 (the U-Net pools to
    2^2), through cuDNN in float32, against the twin's flax path."""
    tree = seeded_variables(tnets.DeepInversionGenerator(4, 2), 52)
    folder = _write_folder(tmp_path, "CGANRegression", {"G": tree},
                           regression="None", nx=32,
                           generator="DeepInversion", div=False)
    model = load_model(folder, device="cpu")
    twin = _scalers(jgan.CGANRegression(folder=MISSING, nx=32,
                                        generator="DeepInversion"), SCALERS)
    twin.vars_G = tree
    q, z = _inputs(32, 9)
    _close(_port(model, q, z), _twin(twin, q, z))


@pytest.fixture(scope="module")
def bottleneck(tmp_path_factory):
    """A CVAEBottleneck folder at 32^2 on seeded weights (the deep decoder
    reaches 2^2, n_up = 4), with its mean net; and its twin."""
    nx = 32
    trees = {"deep_decoder": seeded_variables(
        tnets.Upsampling(100, 4, 2, nx=nx), 53),
        "decoder": _andrew_tree(4, False, 54),
        "net_mean": _andrew_tree(2, False, 55)}
    folder = _write_folder(tmp_path_factory.mktemp("bottleneck"),
                           "CVAEBottleneck", trees, regression="full_loss",
                           nx=nx, div=False, decoder_var="adaptive",
                           deep_latent=100)
    twin = _scalers(jbot.CVAEBottleneck(folder=MISSING, nx=nx), SCALERS)
    twin.vars_deep, twin.vars_dec, twin.vars_mean = (
        trees["deep_decoder"], trees["decoder"], trees["net_mean"])
    return folder, twin


def test_bottleneck_matches_twin(bottleneck):
    """The flat latent (members, 100) through the deep decoder, the decoder
    and the mean net, against the twin; one member with a (100,) latent as
    the twin takes it."""
    folder, twin = bottleneck
    model = load_model(folder, device="cpu")
    assert isinstance(model, CVAEBottleneck)
    assert model.latent_shape(32, 32) == (100,)
    q, z = _inputs(32, 10, latent=(100,))
    out = _port(model, q, z)
    _close(out, _twin(twin, q, z))
    _close(model.predict_snapshot(torch.from_numpy(q[0]),
                                  torch.from_numpy(z[0])), out[0])


def test_bottleneck_mean_snapshot(bottleneck):
    """The deterministic sampler's closure averages M flat-latent samples:
    with the port's draws handed to the twin's `generate`, the means agree.
    The twin's own predict_mean_snapshot, inherited from the GAN, draws
    image-shaped noise that its deep decoder's Dense layer cannot take, and
    raises (ROADMAP, queue 3)."""
    folder, twin = bottleneck
    q = _inputs(32, 13)[0][0]
    gen = torch.Generator().manual_seed(0)
    zs = [torch.randn((1, 100), generator=gen).numpy() for _ in range(2)]
    x = np.moveaxis(q, 0, -1)[None] / twin.x_scale.std
    generate = jax.jit(twin.generate)
    ref = sum(np.asarray(generate(jnp.asarray(x), jnp.asarray(z)))
              for z in zs) / 2
    ref = np.moveaxis((ref * twin.y_scale.std)[0], -1, 0)
    out = load_model(folder, device="cpu").predict_mean_snapshot(
        torch.from_numpy(q), M=2, generator=torch.Generator().manual_seed(0))
    _close(out, ref)
    with pytest.raises(Exception, match="Dense_0"):
        twin.predict_mean_snapshot(jnp.asarray(q), M=2)


def test_bottleneck_online_run_matches_twin(bottleneck):
    """Its flat latent through the port's sampler and online step: 2
    members x 32^2, 3 frozen-noise steps, against the twin's online step
    vmapped over the members, to 2e-5 of max|q| (float32 convolutions and
    FFTs summed in another order)."""
    folder, twin = bottleneck
    kw = dict(nx=32, dt=14400.0, tavestart=0.0, precision="single")
    tp, jp = TParams(**kw), JParams(**kw)
    q0 = np.stack([1e3 * tcore.default_initial_q(
        tp, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    z = np.random.default_rng(11).standard_normal((2, 100)).astype(
        np.float32)
    jstep = jax.jit(jax.vmap(jsim.make_online_step(jp, twin, "AR1", -1,
                                                   with_diags=False)))
    carry = jax.vmap(lambda q, n: (
        jcore.init_state(q, jp),
        jsto.SamplerState(noise=n, forcing=jnp.zeros((2, 32, 32),
                                                     jnp.float32),
                          counter=jnp.zeros((), jnp.int32),
                          key=jax.random.PRNGKey(0)), None))(
        jnp.asarray(q0), jnp.asarray(z))
    model = load_model(folder, device="cpu")
    tstep = make_online_step(tp, model, "AR1", -1, with_diags=False)
    tcarry = init_run_carry(tp, q0, 0, model, with_diags=False,
                            device="cpu")
    assert tuple(tcarry[1].noise.shape) == (2, 100)
    tcarry[1].noise = torch.from_numpy(z)
    for _ in range(3):
        carry, tcarry = jstep(carry), tstep(tcarry)
    q_t = tcore.fields(tcarry[0].qh, tp).q.numpy()
    for m in range(2):
        q_j = np.asarray(jcore.fields(carry[0].qh[m], jp).q)
        np.testing.assert_allclose(q_t[m], q_j, rtol=0,
                                   atol=2e-5 * np.abs(q_j).max())


# ------------------------------------------------------------- the nets

class _NCHW(torch.nn.Module):
    """ResUnit (NCHW inside the U-Net) in the twin's NHWC."""

    def __init__(self, unit):
        super().__init__()
        self.unit = unit

    def forward(self, x):
        return self.unit(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


NETS = {
    "res_unit": (lambda: tnets.ResUnit(4, 8), lambda: jnets.ResUnit(8),
                 (2, 16, 16, 4)),
    "res_unit_no_norm": (lambda: tnets.ResUnit(4, 8, bn="None"),
                         lambda: jnets.ResUnit(8, bn="None"),
                         (2, 16, 16, 4)),
    "downsampling": (lambda: tnets.Downsampling(4, 4, 200, nx=32),
                     lambda: jnets.Downsampling(n_down=4, n_out=200, nx=32),
                     (2, 32, 32, 4)),
    "downsampling_map": (
        lambda: tnets.Downsampling(4, 2, 6, nx=16, flatten=False),
        lambda: jnets.Downsampling(n_down=2, n_out=6, nx=16, flatten=False),
        (2, 16, 16, 4)),
    "upsampling": (lambda: tnets.Upsampling(100, 4, 2, nx=32),
                   lambda: jnets.Upsampling(n_up=4, n_out=2, nx=32),
                   (2, 100)),
    "ann": (lambda: tnets.ANN(9, 1), lambda: jnets.ANN(n_out=1),
            (2, 8, 8, 9)),
    "var_cnn": (lambda: tnets.VarCNN(2, 2, hidden_channels=(8, 8),
                                     kernels=(5, 3, 3)),
                lambda: jnets.VarCNN(2, hidden_channels=(8, 8),
                                     kernels=(5, 3, 3)), (2, 16, 16, 2)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_flax(name):
    """Each net on seeded weights against the twin's flax module's apply,
    eval mode."""
    port_net, twin_net, shape = NETS[name]
    net = port_net()
    tree = seeded_variables(net, 60)
    net.load_state_dict(params_from_jax(tree))
    net.eval()
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    ref = jax.jit(lambda v, a: twin_net().apply(v, a, train=False))(tree, x)
    if name.startswith("res_unit"):
        net = _NCHW(net)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)), ref)


# --------------------------------------------------------- weights both ways

def _equal_trees(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


ROUND_TRIP = {
    "andrew_div": lambda: tnets.AndrewCNN(4, 2, div=True),
    "deep_inversion": lambda: tnets.DeepInversionGenerator(4, 2),
    "downsampling": lambda: tnets.Downsampling(4, 4, 200, nx=32),
    "upsampling": lambda: tnets.Upsampling(100, 4, 2, nx=32),
    "ann": lambda: tnets.ANN(9, 1),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_params_round_trip(name):
    """params_to_jax inverts params_from_jax, array for array (nested
    ResUnit_i included), and the bytes the port writes for a tree are the
    bytes flax's serialization writes."""
    net = ROUND_TRIP[name]()
    tree = seeded_variables(net, 61)
    net.load_state_dict(params_from_jax(tree))
    _equal_trees(params_to_jax(net.state_dict()), tree)
    assert to_msgpack_bytes(tree) == serialization.to_bytes(tree)


def test_shipped_weights_round_trip(tmp_path):
    """A shipped generator read by the port, carried into its module and
    back, and written by `save_variables`: flax's msgpack_restore reads the
    file to the shipped tree, array for array."""
    shipped = _restore(f"{MODELS}/eddy_gan_64/G.msgpack")
    net = tnets.AndrewCNN(4, 2)
    net.load_state_dict(params_from_jax(read_msgpack(
        f"{MODELS}/eddy_gan_64/G.msgpack")))
    save_variables(params_to_jax(net.state_dict()),
                   str(tmp_path / "G.msgpack"))
    _equal_trees(_restore(str(tmp_path / "G.msgpack")), shipped)


def test_saved_folder_reads_back_in_twin(bottleneck):
    """A folder the port wrote: every weight file restores through flax's
    msgpack_restore to the tree the port saved, and model_args.json is the
    twin's contract, which names a class of both registries."""
    folder, twin = bottleneck
    for name, tree in (("deep_decoder", twin.vars_deep),
                       ("decoder", twin.vars_dec),
                       ("net_mean", twin.vars_mean)):
        _equal_trees(_restore(f"{folder}/{name}.msgpack"), tree)
    with open(f"{folder}/model_args.json") as f:
        args = json.load(f)
    assert args["model"] in jbase.MODEL_REGISTRY
    assert args == {"model": "CVAEBottleneck", "regression": "full_loss",
                    "nx": 32, "div": False, "decoder_var": "adaptive",
                    "deep_latent": 100}


def test_registry_covers_twin():
    """load_model and the physical closures' constructors cover every class
    of the twin's MODEL_REGISTRY."""
    assert sorted(MODEL_REGISTRY) == sorted(jbase.MODEL_REGISTRY)
    for cls in (CGANRegression, CVAERegression, CVAEBottleneck, OLSModel,
                ANNModel):
        assert MODEL_REGISTRY[cls.__name__] is cls
