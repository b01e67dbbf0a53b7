"""The kernels' plain versions against the Pallas kernels they replace
(pyqg_generative_tpu.ml.pallas_conv in interpret mode, at toy sizes): K1 in
bf16 under each per-member variant name, K2 (the member-packed chain), K3
(the bf16 packing probe) with the variant resolution it drives, and the GZ
pair merge. The kernels themselves are held against their plain versions on
the card by tests/test_torch_package.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from pyqg_generative_torch.ml import fused_conv as tconv
from pyqg_generative_torch.ml.nets import fold_batchnorm as tfold
from pyqg_generative_tpu.ml import pallas_conv as jconv
from pyqg_generative_tpu.ml.nets import fold_batchnorm as jfold

torch.set_num_threads(1)

NX = 16
HID = (8, 8, 8)
KERNELS = (5, 5, 3, 3)


@pytest.fixture(scope="module")
def folded():
    """A random toy AndrewCNN with its BatchNorms folded (flax layout)."""
    rng = np.random.default_rng(0)
    chans = [4] + list(HID) + [2]
    params = {f"Conv_{i}": {
        "kernel": (rng.standard_normal((k, k, chans[i], chans[i + 1]))
                   / np.sqrt(k * k * chans[i])).astype(np.float32),
        "bias": 0.1 * rng.standard_normal(chans[i + 1]).astype(np.float32)}
        for i, k in enumerate(KERNELS)}
    return {"params": params}


def _rest(folded):
    """The chain after Conv_0, renumbered from Conv_0."""
    p = folded["params"]
    return {"params": {f"Conv_{i - 1}": p[f"Conv_{i}"]
                       for i in range(1, len(p))}}


def _x(shape, seed):
    """A nonnegative input, as Conv_0's ReLU output is."""
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _rel_rms(out, ref):
    return float(np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2)))


def _close(out, ref):
    """rtol 2e-4, atol 2e-5*max|ref|: float32 sums in another order (the
    bar of tests/test_pallas_conv.py:49)."""
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("variant", ["dx", "dxf", "dxb", "tap"])
def test_bf16_chain_matches_twin(folded, variant):
    """K1's plain version in bf16 against the Pallas `_fused_call` at
    compute_dtype=bfloat16 in each per-member variant. Both round the
    activation to bf16 at each conv's input and keep bias, ReLU and output in
    float32, so they differ only where a float32 sum taken in another order
    flips a bf16 rounding: relative RMS <= 1e-3. Against the float32 chain,
    relative RMS < 2% (the bar of tests/test_pallas_conv.py:65-76)."""
    rest = _rest(folded)
    pack = jconv.pack_folded_params if variant == "tap" \
        else jconv.pack_folded_params_dx
    w, b, meta = pack(rest, compute_dtype=jnp.bfloat16)
    x = _x((2, NX, NX, HID[0]), 1)
    ref = np.asarray(jconv.fused_cnn_forward(
        jnp.asarray(x), w, b, meta, compute_dtype=jnp.bfloat16,
        interpret=True, variant=variant))
    packed = tconv.pack_folded_params(rest, "cpu", torch.bfloat16)
    assert packed.meta == meta and packed.wflat.dtype == torch.bfloat16
    before = tconv.launches_bf16
    out = tconv.fused_cnn_forward(torch.from_numpy(x), packed).numpy()
    assert tconv.launches_bf16 == before  # a CPU tensor never launches
    assert out.dtype == np.float32
    assert _rel_rms(out, ref) <= 1e-3
    f32 = tconv.fused_cnn_forward(
        torch.from_numpy(x), tconv.pack_folded_params(rest, "cpu")).numpy()
    assert _rel_rms(out, f32) < 2e-2


def test_merged_toy_pair_has_two_groups(folded):
    """Every chain layer of a merged toy pair is found block-diagonal in 2
    groups, so K1-bf16 skips the zero blocks; a toy net alone is dense."""
    pair = tconv.merge_folded_pair(folded, {"params": {
        k: {"kernel": -np.asarray(v["kernel"]), "bias": v["bias"]}
        for k, v in folded["params"].items()}})
    packed = tconv.pack_folded_params(_rest(pair), "cpu", torch.bfloat16)
    assert packed.groups == (2,) * len(KERNELS[1:])
    assert packed.wtc.dtype == torch.bfloat16
    assert tconv.pack_folded_params(_rest(folded), "cpu").groups == (1,) * 3


@pytest.mark.parametrize("layer", [0, 2])
def test_one_layer_plain_matches_twin(folded, layer):
    """Layer i of the toy chain as a one-layer chain (`chain_layer`, the
    form in which the per-layer check runs K1-bf16) through K1's wrapper on
    the CPU: equal to the plain version of the layer packed alone, and to
    the twin's `_fused_call` at bf16 on the same one-layer chain in
    interpret mode, at relative RMS <= 1e-3 (the bf16 bar above)."""
    rest = _rest(folded)["params"]
    one = {"params": {"Conv_0": rest[f"Conv_{layer}"]}}
    packed = tconv.pack_folded_params(_rest(folded), "cpu", torch.bfloat16)
    x = _x((2, NX, NX, packed.meta[layer][1]), 6)
    out = tconv.fused_cnn_forward(torch.from_numpy(x),
                                  tconv.chain_layer(packed, layer)).numpy()
    alone = tconv.fused_cnn_forward_plain(
        torch.from_numpy(x),
        tconv.pack_folded_params(one, "cpu", torch.bfloat16)).numpy()
    np.testing.assert_array_equal(out, alone)
    w, b, meta = jconv.pack_folded_params_dx(one, compute_dtype=jnp.bfloat16)
    ref = np.asarray(jconv.fused_cnn_forward(
        jnp.asarray(x), w, b, meta, compute_dtype=jnp.bfloat16,
        interpret=True, variant="dxf"))
    assert _rel_rms(out, ref) <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_plain_matches_twin(folded, dtype):
    """K2's plain version (one roll and one matmul per tap, member-packed)
    through make_online_cnn(variant="packed") against the twin's packed
    Pallas kernel at B = 3, and against K1's plain version. float32: rtol
    2e-4, atol 2e-5*max (sums in another order); bf16: relative RMS <= 1e-3
    (the bf16 bar above)."""
    x = _x((3, NX, NX, 4), 2)
    ref = np.asarray(jconv.make_online_cnn(
        folded, compute_dtype=getattr(jnp, dtype), interpret=True,
        variant="packed")(jnp.asarray(x)))
    cdt = getattr(torch, dtype)
    apply = tconv.make_online_cnn(folded, cdt, variant="packed",
                                  device="cpu")
    before = tconv.launches_packed
    out = apply(torch.from_numpy(x)).numpy()
    assert tconv.launches_packed == before
    k1 = tconv.make_online_cnn(folded, cdt, variant="dx",
                               device="cpu")(torch.from_numpy(x)).numpy()
    if dtype == "float32":
        _close(out, ref)
        _close(out, k1)
    else:
        assert _rel_rms(out, ref) <= 1e-3 and _rel_rms(out, k1) <= 1e-3


def test_bitcast_probe_and_variants_match_twin():
    """K3's plain version classifies the CPU's packing as the twin's probe
    does in interpret mode ('adj_low'); its words are little-endian memory's
    pairs of adjacent rows; `resolve_variant` agrees with the twin's
    `_resolve_variant` for every variant name."""
    assert tconv.bitcast_packing("cpu") == jconv._bitcast_packing(True) \
        == "adj_low"
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(
        ml_dtypes.bfloat16)
    ref = np.stack([x[0::2], x[1::2]], axis=-1).view(np.uint32)[..., 0]
    before = tconv.launches_probe
    words = tconv.bitcast_pack_words(
        torch.from_numpy(x.view(np.int16)).view(torch.bfloat16))
    assert tconv.launches_probe == before
    np.testing.assert_array_equal(words.numpy(), ref.astype(np.int64))
    for name in tconv.VARIANTS:
        assert tconv.resolve_variant(name, "cpu") == \
            jconv._resolve_variant(name, True)


def test_merge_folded_pair_matches_twin():
    """The GZ pair merge of eddy_gz_48's folded nets is bitwise the twin's,
    and its widths are the mean and variance nets' side by side."""
    trees = []
    for name in ("net_mean", "net_var"):
        with open(f"trained_models/eddy_gz_48/{name}.msgpack", "rb") as f:
            trees.append(serialization.msgpack_restore(f.read()))
    ref = jconv.merge_folded_pair(*(jfold(t) for t in trees))["params"]
    out = tconv.merge_folded_pair(*(tfold(t) for t in trees))["params"]
    assert sorted(out) == sorted(ref)
    for layer in ref:
        for key in ("kernel", "bias"):
            a, b = np.asarray(out[layer][key]), np.asarray(ref[layer][key])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"{layer}/{key}")
    assert out["Conv_1"]["kernel"].shape == (5, 5, 256, 128)
    assert out["Conv_7"]["kernel"].shape == (3, 3, 64, 4)
