"""Rules of the PyTorch port as a package: it never imports the JAX stack,
its entry points refuse to fall back to the CPU unasked, importing it builds
nothing, its models route through the kernels' wrappers, and each kernel
agrees with its plain version on the card. This file imports no JAX, so that
the card's tests run where JAX is not installed:
python -m pytest tests/test_torch_package.py -m cuda --noconftest"""
import ast
import dataclasses
import importlib
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from pyqg_generative_torch.ml import _build, fused_conv
from pyqg_generative_torch.ml.nets import fold_batchnorm
from pyqg_generative_torch.ml.weights import read_msgpack
from pyqg_generative_torch.models import CGANRegression, CVAERegression, \
    MeanVarModel, Parameterization, load_model
from pyqg_generative_torch.qg import core
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.sim import run_ensemble
from pyqg_generative_torch.sim.stochastic import init_sampler

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pyqg_generative_tpu"}
FOLDER = str(ROOT / "trained_models" / "eddy_gan_64")
GZ = str(ROOT / "trained_models" / "r4_eddy_gz_64_op1_s0")
VAE = str(ROOT / "trained_models" / "r4_eddy_vae_64_op1_s0")
# the settings of the port's online paths 2 (GZ) and 3 (VAE)
GZ_PATH = dict(inference_dtype="bfloat16", online_variant="dxbpair")
VAE_PATH = dict(online_variant="packed")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports():
    files = sorted((ROOT / "pyqg_generative_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """device=None means CUDA: without it every entry point raises rather
    than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = QGParams(nx=16, tmax=2 * 14400.0)
    folded = {"params": {f"Conv_{i}": {"kernel": np.ones((3, 3, 2, 2)),
                                       "bias": np.zeros(2)}
                         for i in range(2)}}
    calls = [lambda: load_model(FOLDER),
             lambda: CGANRegression(folder=FOLDER),
             lambda: MeanVarModel(folder=GZ),
             lambda: CVAERegression(folder=VAE),
             lambda: run_ensemble(p, n_ens=1, sampling_freq=14400.0),
             lambda: core.init_state(np.zeros((2, 16, 16)), p),
             lambda: init_sampler(0, Parameterization(), 16, 16,
                                  torch.float32),
             lambda: fused_conv.make_online_cnn(folded)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_module_import_builds_nothing(monkeypatch):
    """Importing the kernel module neither compiles nor needs nvcc, and the
    CPU path runs with no compiler at hand."""
    def no_compiler(*a, **k):
        raise AssertionError("a compiler was started")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    monkeypatch.setattr(subprocess, "Popen", no_compiler)
    monkeypatch.setenv("PATH", "")
    importlib.reload(_build)
    importlib.reload(fused_conv)
    counts = ("launches", "launches_bf16", "launches_packed",
              "launches_probe")
    assert _build._LOADED == {}
    assert all(getattr(fused_conv, c) == 0 for c in counts)
    folded = {"params": {f"Conv_{i}": {
        "kernel": np.full((3, 3, 2, 2), 0.1, np.float32),
        "bias": np.zeros(2, np.float32)} for i in range(2)}}
    packed = fused_conv.pack_folded_params(folded, "cpu")
    out = fused_conv.fused_cnn_forward(torch.ones(1, 8, 8, 2), packed)
    assert out.shape == (1, 8, 8, 2)
    out = fused_conv.packed_cnn_forward(torch.ones(1, 8, 8, 2), packed)
    assert out.shape == (1, 8, 8, 2)
    assert fused_conv.bitcast_packing("cpu") == "adj_low"
    assert all(getattr(fused_conv, c) == 0 for c in counts)
    assert _build._LOADED == {}


def test_saved_model_routes_through_k1_wrapper(monkeypatch):
    """A model loaded with its saved arguments alone sends Conv_1..Conv_7
    through K1's wrapper: on the CPU the wrapper takes the plain version,
    so its calls are counted here by a spy."""
    calls = []
    real = fused_conv.fused_cnn_forward

    def spy(x, packed):
        calls.append(tuple(x.shape))
        return real(x, packed)

    monkeypatch.setattr(fused_conv, "fused_cnn_forward", spy)
    model = load_model(FOLDER, device="cpu")
    q = torch.zeros((3, 2, 16, 16))
    out = model(q, torch.ones((3, 16, 16, 2)))
    assert out.shape == q.shape and calls == [(3, 16, 16, 128)]


def test_gz_and_vae_route_through_kernel_wrappers(monkeypatch):
    """The GZ model with path 2's settings sends its merged pair through
    K1's wrapper once a closure call (256 channels in, bf16 weights), and
    resolves "dxb" through K3's; the VAE with path 3's sends its decoder
    through K2's once a call, NHWC as K1's. Spies count the calls on the
    CPU, where each wrapper takes its plain version."""
    calls = []
    for name in ("fused_cnn_forward", "packed_cnn_forward",
                 "bitcast_pack_words"):
        real = getattr(fused_conv, name)

        def spy(x, *args, _name=name, _real=real):
            calls.append((_name, tuple(x.shape), x.dtype))
            return _real(x, *args)

        monkeypatch.setattr(fused_conv, name, spy)
    fused_conv.bitcast_packing.cache_clear()
    q = torch.zeros((3, 2, 16, 16))
    z = torch.ones((3, 16, 16, 2))
    gz = load_model(GZ, device="cpu", **GZ_PATH)
    assert gz(q, z).shape == q.shape
    assert gz._online_fns()[0].packed.wflat.dtype == torch.bfloat16
    assert calls == [("bitcast_pack_words", (4, 128), torch.bfloat16),
                     ("fused_cnn_forward", (3, 16, 16, 256), torch.float32)]
    calls.clear()
    vae = load_model(VAE, device="cpu", **VAE_PATH)
    assert vae(q, z).shape == q.shape
    assert calls == [("packed_cnn_forward", (3, 16, 16, 128), torch.float32)]


def test_groups_read_off_saved_weights():
    """K1-bf16 skips the zero blocks of a block-diagonal layer, and reads
    the blocks off the weights: every chain layer of the merged GZ pair
    (r4_eddy_gz_64_op1_s0) has 2 groups, every layer of eddy_gan_64 one."""
    assert _gz_pair_chain("cpu").groups == (2,) * 7
    gan = fold_batchnorm(read_msgpack(f"{FOLDER}/G.msgpack"))
    packed = fused_conv.pack_folded_params(gan, "cpu", torch.bfloat16)
    assert packed.groups == (1,) * 8


def test_stray_weight_makes_layer_dense():
    """One nonzero weight outside the diagonal blocks makes a layer dense;
    exact zeros there keep it grouped, whatever the blocks hold."""
    k = np.zeros((3, 3, 16, 8), np.float32)
    k[:, :, :8, :4] = 1.0
    k[:, :, 8:, 4:] = -2.0
    assert fused_conv.weight_groups(k) == 2
    k[1, 2, 3, 6] = 1e-30
    assert fused_conv.weight_groups(k) == 1
    assert fused_conv.weight_groups(np.ones((5, 5, 4, 6), np.float32)) == 1


@pytest.mark.parametrize("shape,groups", [((5, 5, 256, 128), 2),
                                          ((3, 3, 64, 4), 2),
                                          ((3, 3, 24, 80), 1),
                                          ((3, 3, 2, 2), 1)])
def test_tensor_core_layout_unpacks_to_hwio(shape, groups):
    """K1-bf16's weight buffer, unpacked by a numpy re-index of its layout
    (group, n-tile, chunk of 16 input channels, tap, 8-channel half, n, 8
    channels), gives back the HWIO kernel exactly: each diagonal block
    where it belongs, zeros elsewhere and in the padding."""
    K, _, cin, cout = shape
    rng = np.random.default_rng(14)
    kernel = rng.standard_normal(shape).astype(np.float32)
    ci, co = cin // groups, cout // groups
    for g in range(groups):
        block = kernel[:, :, g * ci:(g + 1) * ci, g * co:(g + 1) * co].copy()
        kernel[:, :, g * ci:(g + 1) * ci, :] = 0
        kernel[:, :, g * ci:(g + 1) * ci, g * co:(g + 1) * co] = block
    flat = fused_conv.tensor_core_weights(kernel, groups)
    N = fused_conv.n_tile(co)
    nt, nc = -(-co // N), -(-ci // 16)
    assert flat.size == groups * nt * nc * K * K * 2 * N * 8
    t = flat.reshape(groups, nt, nc, K * K, 2, N, 8)
    back = np.zeros_like(kernel)
    for g in range(groups):
        # (t, c, tap, half, n, k) -> (tap, c, half, k, t, n)
        blk = t[g].transpose(2, 1, 3, 5, 0, 4).reshape(
            K, K, nc * 16, nt * N)
        assert not blk[:, :, ci:].any() and not blk[:, :, :, co:].any()
        back[:, :, g * ci:(g + 1) * ci, g * co:(g + 1) * co] = \
            blk[:, :, :ci, :co]
    np.testing.assert_array_equal(back, kernel)


def test_chain_layer_views_match_one_layer_packs():
    """`chain_layer` cuts layer i out of a packed chain: its weights,
    biases, tensor-core weights, meta and groups are those of the layer
    packed alone."""
    pair = _gz_pair_chain("cpu")
    for i in (0, 3, 6):
        one = fused_conv.chain_layer(pair, i)
        k = one.weights[0].permute(2, 3, 1, 0).numpy()
        alone = fused_conv.pack_folded_params({"params": {"Conv_0": {
            "kernel": k, "bias": one.biases[0].numpy()}}}, "cpu",
            torch.bfloat16)
        assert one.meta == alone.meta and one.groups == alone.groups
        for name in ("wflat", "bflat", "wtc"):
            assert torch.equal(getattr(one, name), getattr(alone, name))


def _toy_chain(rng):
    """A random 3-layer chain of a 5x5 then two 3x3 layers, 8 -> 2 channels,
    BN-folded (flax layout)."""
    return _random_chain(rng, (8, 8, 8, 2), (5, 3, 3))


@pytest.mark.parametrize("H,W", [(16, 16), (16, 24)])
def test_k2_plain_on_nhwc_equals_k1_plain(H, W):
    """K2's plain version (the twin's roll-and-matmul formulation on its
    member-packed layout, reached from NHWC inside) equals K1's plain
    version (circular conv) on the same NHWC input, float32, at rtol 1e-5:
    the two sum each output in another order. The second grid is not
    square, which K2 now takes."""
    rng = np.random.default_rng(16)
    packed = fused_conv.pack_folded_params(_toy_chain(rng), "cpu")
    x = torch.from_numpy(np.abs(rng.standard_normal((3, H, W, 8))).astype(
        np.float32))
    out = fused_conv.packed_cnn_forward(x, packed)
    ref = fused_conv.fused_cnn_forward_plain(x, packed)
    assert out.shape == (3, H, W, 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def test_layer_check_k2_route_on_cpu():
    """`layer_check` with K2's wrapper as the chain's forward passes both
    parts on the CPU (its plain version), and fails part 1 when the forward
    sees Conv_1's weights scaled by 1 + 1e-4, the reference the unscaled
    ones: the mutation that the chain-level bar (rtol 2e-4) lets pass."""
    rng = np.random.default_rng(17)
    packed = fused_conv.pack_folded_params(_toy_chain(rng), "cpu")
    x = torch.from_numpy(np.abs(rng.standard_normal((2, 16, 16, 8))).astype(
        np.float32))
    rep = fused_conv.layer_check(x, packed, fused_conv.packed_cnn_forward)
    assert max(rel for rel, _, _ in rep["layers"]) <= fused_conv.LAYER_BAR
    assert rep["composed_equal"]

    def scaled_conv1(x, p):
        if p.meta[0][0] == 5:  # the chain's one 5x5 layer, Conv_1
            p = dataclasses.replace(
                p, weights=(p.weights[0] * (1 + 1e-4),) + p.weights[1:])
        return fused_conv.packed_cnn_forward(x, p)

    rep = fused_conv.layer_check(x, packed, scaled_conv1)
    rels = [rel for rel, _, _ in rep["layers"]]
    assert rels[0] > fused_conv.LAYER_BAR
    assert max(rels[1:]) <= fused_conv.LAYER_BAR
    ref = fused_conv.packed_cnn_forward(x, packed)
    np.testing.assert_allclose(scaled_conv1(x, packed).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("script", ["torch_k1_bf16_mutations",
                                    "torch_f32_mutations",
                                    "torch_conv_fma_tiles"])
def test_card_scripts_find_their_sources(script, monkeypatch):
    """The card's mutation and tile-sweep scripts change a copy of the
    kernels' sources by exact text substitution; every text they replace is
    found exactly once in the package's sources, so that an edit of a
    source line they name shows here, with no compiler and no card."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    mod = importlib.import_module(script)
    if script == "torch_conv_fma_tiles":
        for name in mod.VARIANTS:
            mod.variant_source(name)
        return
    pkg = ROOT / "pyqg_generative_torch"
    for name, mutant in mod.MUTANTS.items():
        if mutant:
            assert (pkg / mutant[0]).read_text().count(mutant[1]) == 1, name


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _rel_rms(out, ref):
    return float(((out - ref) ** 2).mean().sqrt() / (ref ** 2).mean().sqrt())


@pytest.mark.cuda
def test_saved_model_launches_k1_on_card():
    """On the card, the model loaded with its saved arguments alone launches
    K1 once per closure call: no argument turns the kernel off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    model = load_model(FOLDER, device="cuda")
    before = fused_conv.launches
    out = model(torch.zeros((3, 2, 16, 16), device="cuda"),
                torch.ones((3, 16, 16, 2), device="cuda"))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert fused_conv.launches == before + 1


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card():
    """K1 on the card against its plain version at the main path's widths
    (eddy_gan_64) and on a toy chain over a grid that is no multiple of the
    kernel's 32-column tile. rtol 2e-4, atol 2e-5*max: float32 sums in
    another order (the bar of tests/test_pallas_conv.py:49)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    toy = {"params": {f"Conv_{i}": {
        "kernel": np.full((3, 3, 2, 2), 0.1, np.float32),
        "bias": np.zeros(2, np.float32)} for i in range(2)}}
    gan = fold_batchnorm(read_msgpack(f"{FOLDER}/G.msgpack"))["params"]
    rest = {"params": {f"Conv_{i - 1}": gan[f"Conv_{i}"]
                       for i in range(1, len(gan))}}
    rng = np.random.default_rng(9)
    for tree, shape in ((rest, (10, 64, 64, 128)), (toy, (3, 40, 40, 2))):
        packed = fused_conv.pack_folded_params(tree, "cuda")
        x = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(
            np.float32)).cuda()
        before = fused_conv.launches
        out = fused_conv.fused_cnn_forward(x, packed)
        torch.cuda.synchronize()
        assert fused_conv.launches == before + 1
        ref = fused_conv.fused_cnn_forward_plain(x, packed).cpu().numpy()
        np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * np.abs(ref).max())


@pytest.mark.cuda
def test_saved_closures_launch_their_kernels_on_card():
    """On the card, the GZ model with path 2's settings launches K3 when it
    resolves "dxb" and K1-bf16 once a closure call; the VAE with path 3's
    launches K2 once a call."""
    _need_card()
    fused_conv.bitcast_packing.cache_clear()
    q = torch.zeros((3, 2, 16, 16), device="cuda")
    z = torch.ones((3, 16, 16, 2), device="cuda")
    for folder, kw, count in ((GZ, GZ_PATH, "launches_bf16"),
                              (VAE, VAE_PATH, "launches_packed")):
        probes = fused_conv.launches_probe
        before = getattr(fused_conv, count)
        out = load_model(folder, device="cuda", **kw)(q, z)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert getattr(fused_conv, count) == before + 1
        assert fused_conv.launches_probe == probes + (folder == GZ)


def _gz_pair_chain(device):
    """The merged GZ pair after Conv_0, packed in bf16 (path 2's chain)."""
    pair = fused_conv.merge_folded_pair(*(
        fold_batchnorm(read_msgpack(f"{GZ}/{n}.msgpack"))
        for n in ("net_mean", "net_var")))["params"]
    return fused_conv.pack_folded_params(
        {"params": {f"Conv_{i - 1}": pair[f"Conv_{i}"]
                    for i in range(1, len(pair))}}, device, torch.bfloat16)


def _random_chain(rng, chans, kernels):
    """A random BN-folded chain (flax layout) of widths `chans`."""
    return {"params": {f"Conv_{i}": {
        "kernel": (rng.standard_normal((k, k, chans[i], chans[i + 1]))
                   / np.sqrt(k * k * chans[i])).astype(np.float32),
        "bias": 0.1 * rng.standard_normal(chans[i + 1]).astype(np.float32)}
        for i, k in enumerate(kernels)}}


def _merged_random_pair(rng, chans, kernels):
    """Two random chains merged block-diagonally, as the GZ pair is; the
    first layer too, so that the chain reads [input_a | input_b]."""
    a, b = (_random_chain(rng, chans, kernels)["params"] for _ in range(2))
    out = {}
    for name in a:
        ka, kb = a[name]["kernel"], b[name]["kernel"]
        K, _, ci, co = ka.shape
        k = np.zeros((K, K, 2 * ci, 2 * co), np.float32)
        k[:, :, :ci, :co], k[:, :, ci:, co:] = ka, kb
        out[name] = {"kernel": k, "bias": np.concatenate(
            [a[name]["bias"], b[name]["bias"]])}
    return {"params": out}


def _hold_layers(packed, x, forward=None, count="launches_bf16"):
    """A chain kernel (K1-bf16 by default; K1 or K2 in float32 with their
    wrapper `forward` and launch count) by the two-part check of
    `fused_conv.layer_check`: every layer against float64 at relative RMS
    <= LAYER_BAR, and the chain equal to its layers composed, bitwise; each
    wrapper call launches once."""
    before = getattr(fused_conv, count)
    rep = fused_conv.layer_check(x, packed, forward)
    torch.cuda.synchronize()
    assert getattr(fused_conv, count) == before + 2 * len(packed.meta) + 1
    worst = max(rel for rel, _, _ in rep["layers"])
    assert worst <= fused_conv.LAYER_BAR, rep["layers"]
    assert rep["composed_equal"]


@pytest.mark.cuda
def test_k1_bf16_matches_plain_on_card():
    """K1-bf16 on the tensor cores, on the merged GZ pair at path 2's shapes
    (10 x 64^2, 256 channels in, 2 groups) and on a toy chain (2 channels)
    over a grid that is no multiple of the kernel's 64-pixel rows. The
    kernel sums in its own order, and over a chain the flipped bf16
    roundings cascade (relative RMS 1e-3 to 3e-3 against the plain version
    on an H100), so no chain-level bar tells a right kernel from a wrong
    one. It is held instead by the two-part check: each layer, on its input
    as the plain chain computes it, against float64 at relative RMS <=
    3e-5, beside the plain version's own error; and the chain equal,
    bitwise, to its layers composed."""
    _need_card()
    toy = {"params": {f"Conv_{i}": {
        "kernel": np.full((3, 3, 2, 2), 0.1, np.float32),
        "bias": np.zeros(2, np.float32)} for i in range(2)}}
    rng = np.random.default_rng(10)
    for packed, shape in (
            (_gz_pair_chain("cuda"), (10, 64, 64, 256)),
            (fused_conv.pack_folded_params(toy, "cuda", torch.bfloat16),
             (3, 40, 40, 2))):
        x = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(
            np.float32)).cuda()
        _hold_layers(packed, x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["merged_pair_48", "single_96",
                                  "single_32x48"])
def test_k1_bf16_layers_on_card(case):
    """The two-part check of K1-bf16 on random chains: a merged pair at
    3 x 48^2 (2 groups a layer), a single-group GAN-shaped chain at 2 x 96^2
    (two 64-pixel chunks a row, the second ragged) and at 2 x 32 x 48 (a
    grid that is not square)."""
    _need_card()
    rng = np.random.default_rng(13)
    kernels = (5, 3, 3, 3, 3, 3, 3)
    B, H, W = {"merged_pair_48": (3, 48, 48), "single_96": (2, 96, 96),
               "single_32x48": (2, 32, 48)}[case]
    if case == "merged_pair_48":
        tree = _merged_random_pair(rng, (128, 64, 32, 32, 32, 32, 32, 2),
                                   kernels)
    else:
        tree = _random_chain(rng, (128, 64, 32, 32, 32, 32, 32, 2), kernels)
    packed = fused_conv.pack_folded_params(tree, "cuda", torch.bfloat16)
    assert set(packed.groups) == {2 if case == "merged_pair_48" else 1}
    x = torch.from_numpy(np.abs(rng.standard_normal(
        (B, H, W, packed.meta[0][1]))).astype(np.float32)).cuda()
    _hold_layers(packed, x)


@pytest.mark.cuda
def test_k2_matches_plain_on_card():
    """K2 against its plain version (one roll and one matmul per tap) on the
    VAE decoder at path 3's shapes (10 x 64^2) and on random widths at
    3 x 48^2, float32: rtol 2e-4, atol 2e-5*max (sums in another order).
    In bf16 on the decoder: relative RMS <= 1e-3 against K1's plain version,
    which sums in the kernel's order. K2's own plain version sums in another
    order, so bf16 roundings flip and cascade (relative RMS 4.1e-3 read on
    an H100); it is no bf16 reference. Input and output are NHWC."""
    _need_card()
    dec = fold_batchnorm(read_msgpack(f"{VAE}/decoder.msgpack"))["params"]
    rest = {"params": {f"Conv_{i - 1}": dec[f"Conv_{i}"]
                       for i in range(1, len(dec))}}
    rng = np.random.default_rng(11)
    chans = (128, 64, 32, 32, 2)
    rand = {"params": {f"Conv_{i}": {
        "kernel": (rng.standard_normal((k, k, chans[i], chans[i + 1]))
                   / np.sqrt(k * k * chans[i])).astype(np.float32),
        "bias": 0.1 * rng.standard_normal(chans[i + 1]).astype(np.float32)}
        for i, k in enumerate((5, 3, 3, 3))}}
    for tree, B, H, dtype in ((rest, 10, 64, torch.float32),
                              (rand, 3, 48, torch.float32),
                              (rest, 10, 64, torch.bfloat16)):
        packed = fused_conv.pack_folded_params(tree, "cuda", dtype)
        x = torch.from_numpy(np.abs(rng.standard_normal(
            (B, H, H, 128))).astype(np.float32)).cuda()
        before = fused_conv.launches_packed
        out = fused_conv.packed_cnn_forward(x, packed)
        torch.cuda.synchronize()
        assert fused_conv.launches_packed == before + 1
        assert out.shape == (B, H, H, packed.meta[-1][2])
        if dtype == torch.bfloat16:
            k1 = fused_conv.fused_cnn_forward_plain(x, packed)
            assert _rel_rms(out, k1) <= 1e-3
        else:
            ref = fused_conv.packed_cnn_forward_plain(x, packed)
            np.testing.assert_allclose(
                out.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4,
                atol=2e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_k2_on_two_streams_on_card():
    """K2 launched on two streams at once: each stream's launches draw their
    work items from their own counters, so every output equals the same
    call's output alone, bitwise. The chain is small enough (2 x 32^2) that
    a launch takes less than the resident grid, and both streams' launches
    queue behind a sleeping kernel, so that they run side by side."""
    _need_card()
    rng = np.random.default_rng(18)
    packed = fused_conv.pack_folded_params(
        _random_chain(rng, (128, 64, 32, 32, 32, 2), (5, 3, 3, 3, 3)),
        "cuda")
    xs = [torch.from_numpy(np.abs(rng.standard_normal(
        (2, 32, 32, 128))).astype(np.float32)).cuda() for _ in range(2)]
    alone = [fused_conv.packed_cnn_forward(x, packed) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
    for _ in range(20):
        for s, x, out in zip(streams, xs, outs):
            with torch.cuda.stream(s):
                out.append(fused_conv.packed_cnn_forward(x, packed))
    torch.cuda.synchronize()
    for ref, out in zip(alone, outs):
        assert all(torch.equal(o, ref) for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1_48", "k1_96", "k2_48", "k2_32x48"])
def test_f32_kernels_layers_on_card(case):
    """The two-part check of K1 and K2 in float32 on a random GAN-shaped
    chain: at 3 x 48^2 (a ragged second 32-column tile), at 2 x 96^2 (K1:
    three tiles a row) and at 2 x 32 x 48 (K2: a grid that is not square)."""
    _need_card()
    forward, count = {"k1": (fused_conv.fused_cnn_forward, "launches"),
                      "k2": (fused_conv.packed_cnn_forward,
                             "launches_packed")}[case[:2]]
    B, H, W = {"k1_48": (3, 48, 48), "k1_96": (2, 96, 96),
               "k2_48": (3, 48, 48), "k2_32x48": (2, 32, 48)}[case]
    rng = np.random.default_rng(15)
    tree = _random_chain(rng, (128, 64, 32, 32, 32, 32, 32, 2),
                         (5, 3, 3, 3, 3, 3, 3))
    packed = fused_conv.pack_folded_params(tree, "cuda")
    x = torch.from_numpy(np.abs(rng.standard_normal(
        (B, H, W, 128))).astype(np.float32)).cuda()
    _hold_layers(packed, x, forward, count)


@pytest.mark.cuda
def test_k3_matches_plain_on_card():
    """K3's words equal its plain version's exactly, on the probe's input
    and on random bf16, as int64 from one launch, and the card packs bf16
    pairs 'adj_low'."""
    _need_card()
    x = torch.randn((8, 128), generator=torch.Generator().manual_seed(12)
                    ).to(torch.bfloat16)
    before = fused_conv.launches_probe
    words = fused_conv.bitcast_pack_words(x.cuda()).cpu()
    assert fused_conv.launches_probe == before + 1
    assert words.dtype == torch.int64
    assert torch.equal(words, fused_conv.bitcast_pack_words_plain(x))
    fused_conv.bitcast_packing.cache_clear()
    assert fused_conv.bitcast_packing("cuda") == "adj_low"
