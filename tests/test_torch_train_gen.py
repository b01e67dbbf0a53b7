"""The port's generative training against the JAX twin on the CPU: the GAN's
batch step (critic with its gradient penalty and drift, and the generator
every fifth batch) and one step of each VAE's loss, in float64 on injected
draws; bit-for-bit resume of the GAN and the VAE, and stable-epoch
selection over the GAN's bank; the DeepInversion generator trained and
reloaded.

The twins' nets are the port's layouts at narrow widths, computing in
float64 (their `dtype`), with random weights from
`ml.weights.seeded_variables`; no flax `init` runs. torch cannot draw the
twin's threefry keys, so each test draws the twin's z1, z2, eps and swap
(or the VAE's eps) from the twin's key as the twin does, and hands the same
arrays to the port."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml import train as tt
from pyqg_generative_torch.ml.weights import params_from_jax, \
    params_to_jax, seeded_variables
from pyqg_generative_torch.models import CGANRegression, CVAEBottleneck, \
    CVAERegression, load_model
from pyqg_generative_torch.models import cgan_regression as tgan
from pyqg_generative_torch.models import cvae_regression as tvae
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_tpu.ml import nets as jnets
from pyqg_generative_tpu.models import base as jbase
from pyqg_generative_tpu.models import cgan_regression as jgan
from pyqg_generative_tpu.models import cvae_bottleneck as jbot
from pyqg_generative_tpu.models import cvae_regression as jvae

from test_torch_train import NX, as64, assert_tree_close, synthetic, \
    tree_max

torch.set_num_threads(1)

MISSING = "/nonexistent_model_folder"
SMALL = dict(hidden_channels=(8,))
DIMS = (8, 8, 8, 8)  # the bottleneck's encoder and deep decoder, narrow
B = 4


def _load(module, seed):
    """Seeded float64 weights into the port's module; the flax tree."""
    module.double()
    tree = as64(seeded_variables(module, seed))
    module.load_state_dict(params_from_jax(tree))
    return tree


def _by_module(flat: dict) -> dict:
    """{"enc.Conv_0.weight": t, ...} -> {"enc": flax params tree, ...}."""
    groups = {}
    for k, v in flat.items():
        m, rest = k.split(".", 1)
        groups.setdefault(m, {})[rest] = v
    return {m: params_to_jax(sd)["params"] for m, sd in groups.items()}


@jax.jit
def _twin_gan_draws(kb):
    """The twin's draws of `make_gan_batch_step` (:497-503, :520-521) for
    a batch of B images."""
    kz1, kz2, keps, kswap, _ = jax.random.split(kb, 5)
    zshape = (B, NX, NX, 2)
    return (jax.random.normal(kz1, zshape), jax.random.normal(kz2, zshape),
            jax.random.uniform(keps, (B, 1, 1, 1)),
            jax.random.bernoulli(kswap))


def _key_with_swap(swap: bool, start: int):
    """The first key from `start` whose swap draw is `swap`, and the
    draws as tensors."""
    for t in range(start, start + 64):
        kb = jax.random.PRNGKey(t)
        draws = _twin_gan_draws(kb)
        if bool(draws[3]) == swap:
            return kb, tuple(torch.tensor(np.asarray(a)) for a in draws)
    raise AssertionError("no key")


def _assert_opt_close(port, twin, rtol):
    adam = twin[0]
    assert port["count"] == int(adam.count) == int(twin[1].count)
    for k in ("mu", "nu"):
        assert_tree_close(params_to_jax(port[k])["params"],
                          getattr(adam, k), rtol, k)


@pytest.fixture(scope="module")
def twin_gan_step():
    """The twin's GAN with narrow nets in float64 (the critic 8 wide), its
    optimizers (cgan_regression.py:600-604) at 4 epochs of 3 batches, and
    its batch step, jitted once for the module."""
    twin = jgan.CGANRegression(nx=NX, folder=MISSING, **SMALL)
    twin.G = jnets.AndrewCNN(n_out=2, dtype=jnp.float64, **SMALL)
    twin.D = jnets.DCGANDiscriminator(ndf=8, nx=NX, dtype=jnp.float64)
    twin.vars_D = {"params": {}, "batch_stats": {}}
    sched = [int(4 * f) * 3 for f in (0.5, 0.75, 0.875)]
    lr = optax.piecewise_constant_schedule(2e-4, {b: 0.5 for b in sched})
    txG = optax.adam(lr, b1=0.5, b2=0.999)
    txD = optax.adam(lr, b1=0.5, b2=0.999)
    return jax.jit(jgan.make_gan_batch_step(twin, txG, txD)), txG, txD


@pytest.mark.parametrize("swaps", [(True, False), (False, True)])
def test_gan_batch_step_is_the_twins(swaps, twin_gan_step):
    """Two batch steps, i = 0 (critic and generator) then i = 1 (critic
    only), each swap as given, in float64: G, D, both optimizers' states
    and G's batch statistics at rtol 1e-8 after each, and the losses."""
    jstep, jtxG, jtxD = twin_gan_step
    port = CGANRegression(nx=NX, folder=MISSING, device="cpu", **SMALL)
    port.D = tnets.DCGANDiscriminator(6, ndf=8, nx=NX)
    treeG, treeD = _load(port.G, 1), _load(port.D, 2)
    carry = (treeG["params"], treeG["batch_stats"],
             jax.jit(jtxG.init)(treeG["params"]), treeD["params"],
             jax.jit(jtxD.init)(treeD["params"]))
    txG, txD = tgan.gan_optimizers(2e-4, 4, 3)
    opt = {"G": txG.init(tt.named_params(port.G)),
           "D": txD.init(tt.named_params(port.D))}
    step = tgan.make_gan_batch_step(port, txG, txD)

    rng = np.random.default_rng(3)
    for i, swap in enumerate(swaps):
        x, y = (rng.standard_normal((B, NX, NX, 2)) for _ in range(2))
        ymean = np.zeros_like(y)
        kb, draws = _key_with_swap(swap, 10 * i)
        carry, jm = jstep(carry, (x, y, ymean), jnp.asarray(i), kb)
        m = step(opt, tuple(torch.tensor(a) for a in (x, y, ymean)), i,
                 draws)
        pG, bsG, oG, pD, oD = carry
        out = params_to_jax(port.G.state_dict())
        assert_tree_close(out["params"], pG, 1e-8, "G")
        assert_tree_close(out["batch_stats"], bsG, 1e-8, "bsG")
        assert_tree_close(params_to_jax(port.D.state_dict())["params"], pD,
                          1e-8, "D")
        _assert_opt_close(opt["G"], oG, 1e-8)
        _assert_opt_close(opt["D"], oD, 1e-8)
        assert opt["G"]["count"] == 1 and opt["D"]["count"] == i + 1
        for k in ("D_loss", "D_grad", "D_drift", "G_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-8, err_msg=k)
        assert (float(m["G_loss"]) == 0) == (i % 5 != 0)


def _vae_pair(bottleneck: bool):
    """The port's and the twin's VAE at narrow widths in float64 (the
    critic 8 wide), on the same seeded weights; the bottleneck with a
    10-number latent and its default regression "full_loss"."""
    if bottleneck:
        port = CVAEBottleneck(nx=NX, folder=MISSING, device="cpu",
                              deep_latent=10)
        port.decoder = tnets.AndrewCNN(4, 2, **SMALL)
        port.encoder = tnets.Downsampling(4, 4, 20, nx=NX, hidden_dims=DIMS)
        port.deep_decoder = tnets.Upsampling(10, 4, 2, nx=NX,
                                             hidden_dims=DIMS)
        twin = jbot.CVAEBottleneck(nx=NX, folder=MISSING, deep_latent=10)
        twin.encoder = jnets.Downsampling(n_down=4, n_out=20, nx=NX,
                                          hidden_dims=DIMS,
                                          dtype=jnp.float64)
        twin.deep_decoder = jnets.Upsampling(n_up=4, n_out=2, nx=NX,
                                             hidden_dims=DIMS,
                                             dtype=jnp.float64)
    else:
        port = CVAERegression(folder=MISSING, device="cpu", **SMALL)
        port.encoder = tnets.AndrewCNN(4, 4, **SMALL)
        twin = jvae.CVAERegression(folder=MISSING, **SMALL)
        twin.encoder = jnets.AndrewCNN(n_out=4, dtype=jnp.float64, **SMALL)
    twin.decoder = jnets.AndrewCNN(n_out=2, dtype=jnp.float64, **SMALL)
    trees = {k: _load(m, 5 + j)
             for j, (k, m) in enumerate(port._vae_modules().items())}
    return port, twin, trees


@pytest.mark.parametrize("bottleneck", [False, True],
                         ids=["CVAERegression", "CVAEBottleneck"])
def test_vae_loss_step_is_the_twins(bottleneck):
    """One step of `make_vae_loss` and Adam on an injected eps, in float64:
    the metrics, every parameter, batch statistic and optimizer moment at
    rtol 1e-8."""
    port, twin, trees = _vae_pair(bottleneck)
    params = {k: t["params"] for k, t in trees.items()}
    bstats = {k: t["batch_stats"] for k, t in trees.items()}
    jtx = optax.adam(2e-4)
    loss_fn = jvae.make_vae_loss(twin)

    eps_shape = (B,) + tuple(port.latent_shape(NX, NX))

    @jax.jit
    def jstep(params, bstats, kz, x, y, ymean):
        (_, (metrics, bstats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, bstats, kz, x, y, ymean, True)
        updates, opt = jtx.update(grads, jtx.init(params), params)
        return (optax.apply_updates(params, updates), bstats, opt, metrics,
                jax.random.normal(kz, eps_shape))

    rng = np.random.default_rng(4)
    x, y, ymean = (rng.standard_normal((B, NX, NX, 2)) for _ in range(3))
    jparams, jbs, jopt, jm, eps = jstep(params, bstats,
                                        jax.random.PRNGKey(7), x, y, ymean)
    tx = tt.Adam(2e-4)
    vparams = tvae.vae_params(port)
    opt = tx.init(vparams)
    m = tvae.make_vae_step(port, tx)(
        opt, tuple(torch.tensor(a) for a in (x, y, ymean)),
        torch.tensor(np.asarray(eps)),
        tx.scalars(next(iter(vparams.values())), 0))
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-8,
                                   err_msg=k)
    for k, module in port._vae_modules().items():
        out = params_to_jax(module.state_dict())
        assert_tree_close(out["params"], jparams[k], 1e-8, k)
        assert_tree_close(out["batch_stats"], jbs[k], 1e-8, k)
    # a bias ahead of a train-mode BatchNorm (the bottleneck's deep
    # decoder) has a zero gradient, which both packages compute as rounding
    # noise; its moments are held at the scale of the module's
    for k in ("mu", "nu"):
        ref = getattr(jopt[0], k)
        for name, tree in _by_module(opt[k]).items():
            assert_tree_close(tree, ref[name], 1e-8, f"{k}/{name}",
                              scale=tree_max(ref[name]))


# ------------------------------------------------------------ resume

@pytest.fixture(scope="module")
def ds_pair():
    return (synthetic(txr, 7, nrun=4, ntime=8),
            synthetic(txr, 8, nrun=2, ntime=4))


def _fit_interrupted(m, ds_train, ds_test, stop_after, **kw):
    """fit() with a simulated crash once the checkpoint of epoch
    `stop_after` is written."""
    orig = tt.TrainCheckpointer.maybe_save

    def crashing(self, epoch, *a, **k):
        orig(self, epoch, *a, **k)
        if self.path and epoch >= stop_after:
            raise KeyboardInterrupt

    tt.TrainCheckpointer.maybe_save = crashing
    try:
        m.fit(ds_train, ds_test, checkpoint_every=2, **kw)
    finally:
        tt.TrainCheckpointer.maybe_save = orig


def _assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _small_vae(folder):
    m = CVAERegression(folder=folder, device="cpu", **SMALL)
    m.encoder = tnets.AndrewCNN(4, 4, **SMALL)
    return m


@pytest.mark.parametrize("kind", ["gan", "vae"])
def test_resume_is_bitwise(tmp_path, ds_pair, kind):
    """A run of 4 epochs, and one interrupted at epoch 2 and resumed by a
    fresh model on the same folder (narrow nets, the critic 8 wide), end
    bit for bit equal (twin:
    tests/test_train_resume.py): every module, the best epoch's weights,
    and the checkpoint gone after the run."""
    ds_train, ds_test = ds_pair
    fit_kw = dict(num_epochs=4, batch_size=16, nruns=2, verbose=False,
                  key=3)
    if kind == "gan":
        fit_kw["retain_every"] = 1

        def make(folder):
            m = CGANRegression(nx=NX, folder=MISSING, device="cpu", **SMALL)
            m.D = tnets.DCGANDiscriminator(6, ndf=8, nx=NX)
            m.folder = folder
            m.load_model(folder)
            return m
        ckpt, best, nets = "gan_train_ckpt.npz", "G_opt.msgpack", ("G", "D")
    else:
        make = _small_vae
        ckpt, best = "vae_train_ckpt.npz", "decoder_opt.msgpack"
        nets = ("encoder", "decoder")
    f_ref, f_int = str(tmp_path / "ref"), str(tmp_path / "int")
    m_ref = make(f_ref)
    m_ref.fit(ds_train, ds_test, **fit_kw)
    with pytest.raises(KeyboardInterrupt):
        _fit_interrupted(make(f_int), ds_train, ds_test, 2, **fit_kw)
    assert os.path.exists(os.path.join(f_int, ckpt))
    m2 = make(f_int)
    m2.fit(ds_train, ds_test, **fit_kw)
    for name in nets:
        _assert_modules_equal(getattr(m_ref, name), getattr(m2, name))
    assert not os.path.exists(os.path.join(f_int, ckpt))
    assert os.path.exists(os.path.join(f_ref, best))
    with open(os.path.join(f_ref, best), "rb") as a, \
            open(os.path.join(f_int, best), "rb") as b:
        assert a.read() == b.read()
    if kind != "gan":
        return
    # the twin reads the folder the port wrote, weights equal
    for name, module in (("G", m2.G), ("D", m2.D)):
        got = jbase.load_variables(seeded_variables(module, 0),
                                   os.path.join(f_int, f"{name}.msgpack"))
        assert_tree_close(got, params_to_jax(module.state_dict()), 0)
    # the epoch bank of both runs, and the stable epoch picked from it by
    # short online runs, each switch a new weights generation
    bank = os.path.join(f_int, "epoch_bank")
    assert sorted(os.listdir(bank)) == [f"G_{e}.msgpack" for e in range(1, 5)]
    generation = m2.weights_generation
    best, results = m2.select_stable_epoch(
        pyqg_params=QGParams(nx=NX, dt=14400.0, precision="double"),
        q_init=ds_train["q"].values[0, 0].astype(np.float64), years=0.001,
        n_ens=1, verbose=False)
    assert best in (1, 2, 3, 4) and sorted(results) == [1, 2, 3, 4]
    assert all(np.isfinite(s) and s > 0 for s, _ in results.values())
    assert m2.weights_generation == generation + 5
    m3 = make(f_int)
    assert m3.use_stable_epoch()
    _assert_modules_equal(m2.G, m3.G)


def test_deepinversion_gan_trains_and_reloads(tmp_path, ds_pair):
    """The U-Net generator trains end to end (twin:
    tests/test_generative.py:209), for one epoch on 2 snapshots here, banks
    it and keeps its best, and reloads through `load_model` with distinct
    draws giving distinct, finite forcings."""
    ds_train, ds_test = ds_pair
    folder = str(tmp_path / "unet")
    m = CGANRegression(nx=NX, folder=folder, generator="DeepInversion",
                       device="cpu")
    m.fit(ds_train.isel(run=[0], time=[0, 1]),
          ds_test.isel(run=[0], time=[0, 1]), num_epochs=1, batch_size=4,
          nruns=1, verbose=False, retain_every=1)
    assert os.path.exists(os.path.join(folder, "G_opt.msgpack"))
    assert os.listdir(os.path.join(folder, "epoch_bank")) == ["G_1.msgpack"]
    m2 = load_model(folder, device="cpu")
    assert m2.generator == "DeepInversion"
    _assert_modules_equal(m.G, m2.G)
    q = torch.tensor(ds_test["q"].values[0, 0])
    g = torch.Generator().manual_seed(0)
    f1, f2 = (m2.predict_snapshot(q, m2.generate_latent_noise(g, NX, NX))
              for _ in range(2))
    assert torch.isfinite(f1).all() and not torch.equal(f1, f2)
