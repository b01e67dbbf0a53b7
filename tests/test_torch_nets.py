"""The port's closure CNN and weight reader against flax, on the CPU."""
import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml.weights import params_from_jax, read_msgpack
from pyqg_generative_tpu.ml import nets as jnets

torch.set_num_threads(1)

G_PATH = "trained_models/eddy_gan_64/G.msgpack"
NX = 16
HID = (8, 8, 8)
KERNELS = (5, 5, 3, 3)


def _close(out, ref):
    """rtol 2e-4, atol 2e-5*max|ref|: float32 convolutions summed in another
    order (the bar of tests/test_pallas_conv.py:49)."""
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def small_net():
    """A random small AndrewCNN tree (flax layout) with non-trivial
    BatchNorm statistics."""
    rng = np.random.default_rng(0)
    chans = [4] + list(HID) + [2]
    params, stats = {}, {}
    for i, k in enumerate(KERNELS):
        cin, cout = chans[i], chans[i + 1]
        params[f"Conv_{i}"] = {
            "kernel": (rng.standard_normal((k, k, cin, cout))
                       / np.sqrt(k * k * cin)).astype(np.float32),
            "bias": 0.1 * rng.standard_normal(cout).astype(np.float32)}
        if i < len(KERNELS) - 1:
            params[f"BatchNorm_{i}"] = {
                "scale": (1 + 0.2 * rng.standard_normal(cout)).astype(
                    np.float32),
                "bias": 0.1 * rng.standard_normal(cout).astype(np.float32)}
            stats[f"BatchNorm_{i}"] = {
                "mean": 0.3 * rng.standard_normal(cout).astype(np.float32),
                "var": (0.5 + rng.random(cout)).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def eddy_gan():
    """eddy_gan_64's generator as flax's own msgpack reader gives it."""
    with open(G_PATH, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_fold_batchnorm_equals_twin(small_net):
    """The numpy fold is the twin's code: equal arrays."""
    t = tnets.fold_batchnorm(small_net)["params"]
    j = jnets.fold_batchnorm(small_net)["params"]
    assert sorted(t) == sorted(j)
    for k in j:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(t[k][leaf], np.asarray(j[k][leaf]))


def _torch_net(variables, fold, n_in=4, **kw):
    if fold:
        variables = tnets.fold_batchnorm(variables)
    net = tnets.AndrewCNN(n_in, 2, batch_norm=not fold, **kw)
    net.load_state_dict(params_from_jax(variables))
    return net.eval(), variables


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_small_cnn_matches_flax(small_net, fold):
    tnet, v = _torch_net(small_net, fold, hidden_channels=HID,
                         kernels=KERNELS)
    x = _x((2, NX, NX, 4), 1)
    jnet = jnets.AndrewCNN(n_out=2, hidden_channels=HID, kernels=KERNELS,
                           batch_norm=not fold)
    ref = np.asarray(jnet.apply(v, x, train=False))
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
    _close(out, ref)


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_eddy_gan_matches_flax(eddy_gan, fold):
    """The trained generator at full width on a 16^2 grid (its weights do
    not depend on the grid), carried across by params_from_jax."""
    tnet, v = _torch_net(eddy_gan, fold)
    x = _x((1, NX, NX, 4), 2)
    jnet = jnets.AndrewCNN(n_out=2, batch_norm=not fold)
    ref = np.asarray(jnet.apply(v, x, train=False))
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
    _close(out, ref)


def test_msgpack_reader_matches_flax(eddy_gan):
    """read_msgpack (msgpack alone) gives flax's tree, leaf for leaf."""
    tree = read_msgpack(G_PATH)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = jax.tree_util.tree_leaves_with_path(eddy_gan)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tree["params"]["Conv_1"]["kernel"].shape == (5, 5, 128, 64)
