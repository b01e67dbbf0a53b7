"""The port's training machinery and its regression closures against the
JAX twin on the CPU: the shuffles, Adam's learning rate at every update
count, flax's train-mode BatchNorm, three steps of the regression loop in
float64, the ANN's stencils, the GAN's offline evaluation and loss log, the
initializers' distributions at full width, and folders written by the
port's `fit` read back by the twin and by the port.

Random weights are flax trees of the port's module layouts from
`ml.weights.seeded_variables`; the twins' states are built by hand as
`TrainingState(params, batch_stats, tx.init(params), 0)` and their calls
jitted, so no flax `init` runs. The twins' nets compute in float64 here
(their `dtype`), as the port's do."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml import train as tt
from pyqg_generative_torch.ml.weights import params_from_jax, \
    params_to_jax, seeded_variables
from pyqg_generative_torch.models import ANNModel, MeanVarModel, OLSModel, \
    load_model
from pyqg_generative_torch.models import ann_model as tann
from pyqg_generative_torch.models import cgan_regression as tgan
from pyqg_generative_torch.models import common as tcommon
from pyqg_generative_torch.models import cvae_regression as tvae
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_torch.utils.checkpoints import load_checkpoint, \
    save_checkpoint
from pyqg_generative_tpu.ml import nets as jnets
from pyqg_generative_tpu.ml import train as jt
from pyqg_generative_tpu.models import ann_model as jann
from pyqg_generative_tpu.models import base as jbase
from pyqg_generative_tpu.models import cgan_regression as jgan
from pyqg_generative_tpu.models import common as jcommon
from pyqg_generative_tpu.utils import xrlite as jxr

torch.set_num_threads(1)

NX = 16


def synthetic(xr, seed, nrun=4, ntime=8, nx=NX):
    """A forcing dataset of the twin's tests (tests/test_closures.py:9): q
    at eddy amplitudes, S = 2e-6 q plus heteroscedastic noise, psi."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nrun, ntime, 2, nx, nx)).astype("float32") * 1e-5
    eps = rng.standard_normal(q.shape).astype("float32")
    S = (2.0 * q + np.abs(q) * eps) * 1e-6
    psi = rng.standard_normal(q.shape).astype("float32") * 1e2
    ds = xr.Dataset()
    for k, v in (("q", q), ("q_forcing_advection", S), ("psi", psi)):
        ds[k] = xr.DataArray(v, dims=("run", "time", "lev", "y", "x"))
    return ds


def as64(tree):
    if isinstance(tree, dict):
        return {k: as64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def tree_max(tree) -> float:
    """The largest |value| in a tree of arrays."""
    if isinstance(tree, dict):
        return max((tree_max(v) for v in tree.values()), default=0.0)
    return float(np.abs(np.asarray(tree)).max(initial=0))


def assert_tree_close(out, ref, rtol, path="", scale=None):
    """Every array of `out` within rtol of `ref`'s, plus rtol times the
    array's largest |value| (or `scale`'s, where given): an entry of a
    gradient sum (or an Adam moment of it) that cancels to 1e-7 of its
    tensor's largest carries the float64 rounding of the terms it is the
    difference of."""
    assert isinstance(out, dict) == isinstance(ref, dict), path
    if isinstance(ref, dict):
        assert sorted(out) == sorted(ref), path
        for k in ref:
            assert_tree_close(out[k], ref[k], rtol, f"{path}/{k}", scale)
        return
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(out), ref, rtol=rtol,
        atol=rtol * (tree_max(ref) if scale is None else scale),
        err_msg=path)


# ------------------------------------------------------------ the machinery

@pytest.mark.parametrize("n,batch", [(48, 16), (50, 16), (10, 16)])
def test_epoch_permutation_is_the_twins(n, batch):
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        np.testing.assert_array_equal(tt.epoch_permutation(ra, n, batch),
                                      jt.epoch_permutation(rb, n, batch))
    assert ra.integers(1 << 30) == rb.integers(1 << 30)


def _optax_rates(tx, counts):
    """The rate optax's Adam applies at each update count: with a constant
    gradient of 1 its update is -lr(count) / (1 + eps)."""
    p = jnp.zeros((), jnp.float64)
    state = tx.init(p)
    update = jax.jit(tx.update)
    rates = []
    for _ in range(counts):
        u, state = update(jnp.ones((), jnp.float64), state, p)
        rates.append(-float(u) * (1 + 1e-8))
    return np.asarray(rates)


def _port_rates(tx, counts):
    p = {"w": torch.zeros((), dtype=torch.float64)}
    state = tx.init(p)
    rates = []
    for _ in range(counts):
        before = float(p["w"])
        tx.step(p, [torch.ones((), dtype=torch.float64)], state)
        rates.append(-(float(p["w"]) - before) * (1 + 1e-8))
    return np.asarray(rates)


@pytest.mark.parametrize("num_epochs", [1, 2, 4, 8])
def test_learning_rate_at_every_count_is_optax(num_epochs):
    """Regression (`multistep_adam`), the GAN's two optimizers and the VAE's:
    the rate at each of the optimizer's own update counts, repeated
    boundaries counted once (num_epochs 1: {0}; 2: {steps}; 4: {2 steps,
    3 steps})."""
    steps, counts = 3, 3 * 8 + 2
    np.testing.assert_allclose(
        _port_rates(tt.multistep_adam(1e-3, num_epochs, steps), counts),
        _optax_rates(jt.multistep_adam(1e-3, num_epochs, steps), counts),
        rtol=1e-12)
    # the twin's inline schedules (cgan_regression.py:600-604,
    # cvae_regression.py:309-312)
    sched = [int(num_epochs * f) * steps for f in (0.5, 0.75, 0.875)]
    gan = optax.adam(optax.piecewise_constant_schedule(
        2e-4, {b: 0.5 for b in sched}), b1=0.5, b2=0.999)
    vae = optax.adam(optax.piecewise_constant_schedule(
        2e-4, {b: 0.1 for b in sched}))
    for port, twin in ((tgan.gan_optimizers(2e-4, num_epochs, steps)[0],
                        gan),
                       (tgan.gan_optimizers(2e-4, num_epochs, steps)[1],
                        gan),
                       (tvae.vae_optimizer(2e-4, num_epochs, steps), vae)):
        np.testing.assert_allclose(_port_rates(port, counts),
                                   _optax_rates(twin, counts), rtol=1e-12)
    if num_epochs == 1:  # G's first update already at half the rate
        assert _port_rates(tgan.gan_optimizers(2e-4, 1, steps)[0], 1)[0] \
            == pytest.approx(1e-4, rel=1e-12)


def test_train_mode_batchnorm_is_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5, 5, 3)) * 3 + 1
    scale, bias = rng.standard_normal(3), rng.standard_normal(3)
    mean, var = rng.standard_normal(3), 0.5 + rng.random(3)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       use_fast_variance=False, dtype=jnp.float64)
    y_ref, upd = jax.jit(lambda v, x: bn.apply(v, x, mutable=["batch_stats"]))(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, x)
    port = tnets.BatchNorm(3).double().train()
    port.load_state_dict({"weight": torch.tensor(scale),
                          "bias": torch.tensor(bias),
                          "running_mean": torch.tensor(mean),
                          "running_var": torch.tensor(var),
                          "num_batches_tracked": torch.tensor(0)})
    y = port(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               upd["batch_stats"]["mean"], rtol=1e-10)
    np.testing.assert_allclose(port.running_var.numpy(),
                               upd["batch_stats"]["var"], rtol=1e-10)


def _regression_nets(hidden=(8,)):
    port = tnets.AndrewCNN(2, 2, hidden_channels=hidden).double()
    tree = as64(seeded_variables(port, 5))
    port.load_state_dict(params_from_jax(tree))
    twin = jnets.AndrewCNN(n_out=2, hidden_channels=hidden,
                           dtype=jnp.float64)
    return port, twin, tree


def test_regression_loop_three_steps_is_the_twins(tmp_path):
    """One epoch of three batches of the regression loop and its test
    epoch, in float64: every parameter and batch statistic at rtol 1e-8,
    the logged losses at rtol 1e-10."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((48, NX, NX, 2))
    Y = rng.standard_normal((48, NX, NX, 2))
    Xt = rng.standard_normal((20, NX, NX, 2))
    Yt = rng.standard_normal((20, NX, NX, 2))
    port, twin, tree = _regression_nets()

    jtx = jt.multistep_adam(1e-3, 1, 3)
    jstate = jt.TrainingState(tree["params"], tree["batch_stats"],
                              jtx.init(tree["params"]), jnp.zeros((), int))
    jstate, jlog = jt.fit(jcommon.mse_loss_fn(twin), jstate, jtx, (X, Y),
                          (Xt, Yt), 1, 16, rng=np.random.default_rng(2),
                          verbose=False)
    ttx = tt.multistep_adam(1e-3, 1, 3)
    state = tt.TrainingState(port, ttx.init(tt.named_params(port)))
    state, log = tt.fit(tcommon.mse_loss_fn(port), state, ttx,
                        (torch.tensor(X), torch.tensor(Y)),
                        (torch.tensor(Xt), torch.tensor(Yt)), 1, 16,
                        rng=np.random.default_rng(2), verbose=False)
    assert state.step == 3 and state.opt_state["count"] == 3
    out = params_to_jax(port.state_dict())
    assert_tree_close(out["params"], jstate.params, 1e-8)
    assert_tree_close(out["batch_stats"], jstate.batch_stats, 1e-8)
    assert sorted(log) == sorted(jlog) == ["loss", "loss_test"]
    for k in log:
        np.testing.assert_allclose(log[k], jlog[k], rtol=1e-10)


def test_training_checkpoint_round_trip(tmp_path):
    """The carry's tree (module state, optimizer state with its count, a
    tuple, None) comes back as it went, each tensor in its dtype."""
    net = tnets.AndrewCNN(2, 2, hidden_channels=(4,))
    tx = tt.multistep_adam(1e-3, 2, 2)
    opt = tx.init(tt.named_params(net))
    opt["count"] = 7
    carry = {"module": net.state_dict(), "opt": opt,
             "pair": (np.arange(3), 1.5), "none": None}
    save_checkpoint(str(tmp_path / "c"), carry)
    template = {"module": tnets.AndrewCNN(2, 2, hidden_channels=(4,)
                                          ).state_dict(),
                "opt": tx.init(tt.named_params(net)),
                "pair": (np.zeros(3, int), 0.0), "none": None}
    back = load_checkpoint(str(tmp_path / "c.npz"), template)
    assert back["opt"]["count"] == 7 and back["none"] is None
    assert back["pair"][1] == 1.5 and isinstance(back["pair"], tuple)
    for k, v in carry["module"].items():
        assert back["module"][k].dtype == v.dtype
        assert torch.equal(back["module"][k], v)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "c.npz"), {"module": template[
            "module"]})


# ------------------------------------------------------------ closures

def test_prepare_data_ann_is_the_twins():
    got = tann.prepare_data_ANN([synthetic(txr, 0), synthetic(txr, 1)], 3)
    want = jann.prepare_data_ANN([synthetic(jxr, 0), synthetic(jxr, 1)], 3)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[2:] == want[2:]


class _Predicted:
    """A closure whose `predict` returns fixed predictions."""

    def __init__(self, preds):
        self.preds = preds
        self.calls = []

    def predict(self, ds, M=16):
        self.calls.append((ds["q"].values.shape, M))
        nrun = ds["q"].values.shape[0]
        return {k: v.isel(run=np.arange(nrun)) for k, v in
                self.preds.items()}


def test_evaluate_prediction_and_loss_log_are_the_twins():
    rng = np.random.default_rng(4)
    sample, mean = (rng.standard_normal((2, 8, 2, NX, NX)) * 1e-11
                    for _ in range(2))
    out = {}
    for name, xr, mod in (("port", txr, tgan), ("twin", jxr, jgan)):
        ds = synthetic(xr, 0, nrun=4)
        preds = {"q_forcing_advection": xr.DataArray(
                     sample, ("run", "time", "lev", "y", "x")),
                 "q_forcing_advection_mean": xr.DataArray(
                     mean, ("run", "time", "lev", "y", "x"))}
        net = _Predicted(preds)
        out[name] = mod.evaluate_prediction(net, ds, nruns=2, key=3)
        assert net.calls == [((2, 8, 2, NX, NX), 16)]
    assert sorted(out["port"]) == sorted(out["twin"])
    for k in out["twin"]:
        np.testing.assert_allclose(out["port"][k], out["twin"][k],
                                   rtol=1e-10)

    log = {"D_loss": [0.3, 0.1, 0.2], "L2_total_test": [0.9, 0.5, 0.7],
           "L2_residual_test": [0.4, 0.6, 0.1]}
    ds, epoch = tgan.loss_to_dataset(log)
    jds, jepoch = jgan.loss_to_dataset(log)
    assert epoch == jepoch == 3
    for k in ("D_loss", "loss_opt", "Epoch_opt"):
        np.testing.assert_allclose(ds[k].values, jds[k].values, rtol=1e-10)
    np.testing.assert_array_equal(ds["D_loss"].coords["epoch"],
                                  jds["D_loss"].coords["epoch"])
    assert tgan.loss_to_dataset({"a": [1.0, 2.0]})[1] == 2


def _flax_draws(key):
    """32,768 draws of each of the twin's initializers: dcgan_normal_init,
    the BatchNorm scale's normal(0.02), and lecun_normal at fan-in 1 (its
    draws at fan-in n are these over sqrt(n))."""
    k1, k2, k3 = jax.random.split(key, 3)
    shape = (1, 32768)
    return {"dcgan": np.asarray(jnets.dcgan_normal_init()(k1, shape,
                                                          jnp.float64)),
            "scale": np.asarray(fnn.initializers.normal(0.02)(
                k2, shape, jnp.float64)),
            "lecun": np.asarray(fnn.initializers.lecun_normal()(
                k3, shape, jnp.float64))}


def _fan_in(shape):
    """flax's fan-in of a kernel (`variance_scaling`, in_axis=-2,
    out_axis=-1)."""
    from jax._src.nn.initializers import _compute_fans
    return _compute_fans(shape, -2, -1)[0]


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _close_in_distribution(a, ref):
    assert abs(a.std() / ref.std() - 1) < 0.05
    assert abs(a.mean() - ref.mean()) < 0.05 * ref.std()


def test_initializers_follow_the_twins_distributions():
    """At full width: every kernel of 4,096 or more entries, and the
    BatchNorm scales pooled, has the mean and standard deviation of the
    twin's initializer on the same flax shape within 5% (of the standard
    deviation, for the mean): N(0, 0.02) for the AndrewCNN's and the
    critic's convs and for BatchNorm scales, flax's lecun_normal at flax's
    fan-in elsewhere. Biases and BatchNorm shifts are zero, running means
    0 and variances 1, the parameter counts the twin's, and the draws the
    generator's alone."""
    modules = [(tnets.AndrewCNN(4, 2), "dcgan"),
               (tnets.DCGANDiscriminator(6, nx=64), "dcgan"),
               (tnets.DeepInversionGenerator(4, 2), "lecun"),
               (tnets.Downsampling(4, 4, 200, nx=64), "lecun"),
               (tnets.Upsampling(100, 4, 2, nx=64), "lecun"),
               (tnets.ANN(9, 1, (24, 24)), "lecun")]
    ref = _flax_draws(jax.random.PRNGKey(0))
    again = tnets.AndrewCNN(4, 2)
    tnets.init_weights(again, torch.Generator().manual_seed(1))
    scales = []
    for module, kind in modules:
        tnets.init_weights(module, torch.Generator().manual_seed(1))
        tree = params_to_jax(module.state_dict())
        assert jnets.count_params(tree) == tnets.count_params(module)
        for path, a in _leaves(tree["params"]):
            if path[-1] == "bias":
                assert not a.any(), path
            elif path[-1] == "scale":
                scales.append(a.ravel())
            elif a.size >= 4096:
                _close_in_distribution(
                    a, ref[kind] / np.sqrt(_fan_in(a.shape))
                    if kind == "lecun" else ref[kind])
        for path, a in _leaves(tree["batch_stats"]):
            assert np.all(a == (0 if path[-1] == "mean" else 1)), path
    _close_in_distribution(np.concatenate(scales), ref["scale"])
    for k, v in again.state_dict().items():
        assert torch.equal(v, modules[0][0].state_dict()[k])


@pytest.mark.parametrize("closure", ["ols", "gz", "ann"])
def test_fit_writes_a_folder_both_packages_read(tmp_path, closure):
    """Two epochs of each regression closure's fit on the CPU: a finite loss
    log, weights the twin's `load_variables` reads equal to the trained
    module's, scalers and model_args of the twin's contract, and the
    folder through the port's `load_model`, whose prediction is the
    trained model's."""
    folder = str(tmp_path / closure)
    small = dict(hidden_channels=(8, 8))
    make = {"ols": lambda: OLSModel(folder=folder, device="cpu", **small),
            "gz": lambda: MeanVarModel(folder=folder, device="cpu", **small),
            "ann": lambda: ANNModel(folder=folder, device="cpu")}[closure]
    model = make()
    model.fit(synthetic(txr, 0), synthetic(txr, 1, nrun=2, ntime=4),
              num_epochs=2, batch_size=16, verbose=False)
    nets = {"net_mean": model.net_mean, "net_var": model.net_var} \
        if closure == "gz" else {"net": model.net}
    for fname, module in nets.items():
        path = f"{folder}/{fname}.msgpack"
        template = seeded_variables(module, 0)
        if closure == "ann":
            template = {"params": template["params"], "batch_stats": {}}
        got = jbase.load_variables(template, path)
        assert_tree_close(got, params_to_jax(module.state_dict()), 0)
    stats = "stats_mean.npz" if closure == "gz" else "stats.npz"
    log = txr.Dataset.from_npz(f"{folder}/{stats}")
    assert np.isfinite(log["loss"].values).all()
    assert log["loss"].values.shape == (2,)
    with open(f"{folder}/model_args.json") as f:
        assert json.load(f)["model"] == type(model).__name__
    loaded = load_model(folder, device="cpu")
    q = torch.tensor(synthetic(txr, 2)["q"].values[0, :2])
    noise = torch.zeros((2, NX, NX, 2))
    np.testing.assert_array_equal(loaded.predict_snapshot(q, noise).numpy(),
                                  model.predict_snapshot(q, noise).numpy())
