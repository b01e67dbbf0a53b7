"""K1, the closure-CNN kernel: its plain PyTorch version against the Pallas
kernel it replaces (pyqg_generative_tpu.ml.pallas_conv, variant "dx", in
interpret mode at toy sizes). The kernel itself is held against the plain
version on the card by tests/test_torch_package.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqg_generative_torch.ml import fused_conv as tconv
from pyqg_generative_tpu.ml import pallas_conv as jconv
from pyqg_generative_tpu.ml.nets import fold_batchnorm

torch.set_num_threads(1)

NX = 16
HID = (8, 8, 8)
KERNELS = (5, 5, 3, 3)


@pytest.fixture(scope="module")
def folded():
    """A BN-folded random toy AndrewCNN (flax layout), numpy."""
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
                "scale": np.ones(cout, np.float32),
                "bias": np.zeros(cout, np.float32)}
            stats[f"BatchNorm_{i}"] = {
                "mean": 0.3 * rng.standard_normal(cout).astype(np.float32),
                "var": (0.5 + rng.random(cout)).astype(np.float32)}
    return fold_batchnorm({"params": params, "batch_stats": stats})


def _close(out, ref):
    """rtol 2e-4, atol 2e-5*max|ref|: float32 sums in another order (the
    bar of tests/test_pallas_conv.py:49)."""
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("B", [1, 3])
def test_plain_k1_matches_pallas_dx(folded, B):
    """The whole toy chain through K1's plain version against the Pallas
    kernel `_fused_call` in variant dx (interpret mode), float32."""
    w, b, meta = jconv.pack_folded_params_dx(folded,
                                             compute_dtype=jnp.float32)
    x = _x((B, NX, NX, 4), B)
    ref = np.asarray(jconv.fused_cnn_forward(
        jnp.asarray(x), w, b, meta, compute_dtype=jnp.float32,
        interpret=True, variant="dx"))
    packed = tconv.pack_folded_params(folded, "cpu")
    assert packed.meta == meta
    before = tconv.launches
    out = tconv.fused_cnn_forward(torch.from_numpy(x), packed)
    assert tconv.launches == before  # a CPU tensor never reaches the kernel
    assert out.shape == (B, NX, NX, 2) and out.dtype == torch.float32
    _close(out.numpy(), ref)


def test_online_cnn_matches_twin(folded):
    """make_online_cnn (Conv_0 in PyTorch, then the chain) against the
    twin's make_online_cnn(variant="dx"), batched and single."""
    x = _x((2, NX, NX, 4), 5)
    ref = np.asarray(jconv.make_online_cnn(
        folded, compute_dtype=jnp.float32, interpret=True,
        variant="dx")(jnp.asarray(x)))
    apply = tconv.make_online_cnn(folded, device="cpu")
    _close(apply(torch.from_numpy(x)).numpy(), ref)
    _close(apply(torch.from_numpy(x[1])).numpy(), ref[1])
