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
from pyqg_generative_torch.ml import nets
from pyqg_generative_torch.ml.nets import fold_batchnorm
from pyqg_generative_torch.ml.weights import params_from_jax, read_msgpack, \
    seeded_variables
from pyqg_generative_torch.models import ANNModel, CGANRegression, \
    CVAEBottleneck, CVAERegression, MeanVarModel, OLSModel, \
    Parameterization, load_model, physical, save_model_args, save_variables
from pyqg_generative_torch.qg import core
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.entry import dryrun_multichip, entry
from pyqg_generative_torch.eval.comparison import \
    coarsegrain_reference_dataset
from pyqg_generative_torch.sim import advance_run, \
    generate_subgrid_forcing, generate_subgrid_forcing_batch, graph, \
    init_run_carry, make_online_step, run_ensemble, \
    run_ensemble_segmented, run_simulation, run_with_snapshots, simulate
from pyqg_generative_torch.sim.stochastic import init_sampler
from pyqg_generative_torch.utils import xrlite as xr
from pyqg_generative_torch.utils.debugging import first_bad_step

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pyqg_generative_tpu"}
FOLDER = str(ROOT / "trained_models" / "eddy_gan_64")
GZ = str(ROOT / "trained_models" / "r4_eddy_gz_64_op1_s0")
VAE = str(ROOT / "trained_models" / "r4_eddy_vae_64_op1_s0")
GAN_OPT = str(ROOT / "trained_models" / "r4_eddy_gan_64_op1_s0")
ANN = str(ROOT / "trained_models" / "ann_eddy_jet")
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
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) > 15
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("qg/operators", "models/physical", "models/ann_model",
                   "models/ols_model", "models/cvae_bottleneck",
                   "models/cvae_regression", "models/cgan_regression",
                   "models/mean_var_model", "models/common", "models/base",
                   "ml/weights", "ml/nets", "ml/train", "ml/train_conv",
                   "ml/train_graph",
                   "qg/spectral",
                   "eval/__init__", "eval/comparison", "eval/metrics",
                   "eval/forecast", "entry", "utils/checkpoints",
                   "exp/__init__", "exp/pipeline", "exp/cli", "ml/multifit",
                   "utils/native", "utils/debugging", "utils/profiling",
                   "utils/step_graphs",
                   "utils/plot", "utils/__init__", "parallel/__init__",
                   "parallel/mesh", "parallel/sweep", "parallel/spawn",
                   "parallel/dryrun"):
        assert f"pyqg_generative_torch/{module}.py" in names
    assert "scripts/torch_online_score.py" in names
    assert "scripts/torch_fastloader_race.py" in names
    assert "scripts/torch_gan_step_kinks.py" in names
    for path in files:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """device=None means CUDA: without it every entry point raises rather
    than run on the CPU unasked, the port's bench, the pipeline's stages
    and the CLI among them."""
    from pyqg_generative_torch.exp import cli, pipeline
    monkeypatch.syspath_prepend(str(ROOT))
    bench_torch = importlib.import_module("bench_torch")
    carry = init_run_carry(QGParams(nx=16), np.zeros((2, 16, 16)), 0,
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = QGParams(nx=16, tmax=2 * 14400.0)
    folded = {"params": {f"Conv_{i}": {"kernel": np.ones((3, 3, 2, 2)),
                                       "bias": np.zeros(2)}
                         for i in range(2)}}
    reference = xr.Dataset()
    for k in ("q", "u", "v", "psi"):
        reference[k] = xr.DataArray(np.zeros((1, 2, 16, 16), np.float32),
                                    ("time", "lev", "y", "x"))
    closures = [getattr(physical, n) for n in physical.__all__
                if n != "PhysicalParameterization"]
    assert len(closures) == 11
    calls = [lambda: load_model(FOLDER),
             lambda: CGANRegression(folder=FOLDER),
             lambda: CGANRegression(folder="missing",
                                    generator="DeepInversion"),
             lambda: MeanVarModel(folder=GZ),
             lambda: CVAERegression(folder=VAE),
             lambda: CVAEBottleneck(folder="missing"),
             lambda: OLSModel(folder="missing"),
             lambda: ANNModel(folder=ANN),
             lambda: load_model(ANN),
             *[lambda c=c: c() for c in closures],
             lambda: run_ensemble(p, n_ens=1, sampling_freq=14400.0),
             lambda: run_ensemble_segmented(p, n_ens=1,
                                            sampling_freq=14400.0),
             lambda: run_simulation(p, sampling_freq=14400.0),
             lambda: next(run_with_snapshots(p, sampling_freq=14400.0)),
             lambda: advance_run(carry, p, sampling_freq=14400.0),
             lambda: bench_torch.main(["--nx", "16", "--members", "1",
                                       "--steps", "2", "--snap-every", "1"]),
             lambda: core.init_state(np.zeros((2, 16, 16)), p),
             lambda: init_sampler(0, Parameterization(), 16, 16,
                                  torch.float32),
             lambda: fused_conv.make_online_cnn(folded),
             lambda: generate_subgrid_forcing([8], p, sampling_freq=14400.0),
             lambda: generate_subgrid_forcing_batch([8], p,
                                                    sampling_freq=14400.0),
             lambda: coarsegrain_reference_dataset(reference, 8,
                                                   "Operator2"),
             lambda: entry(),
             lambda: pipeline.run_reference(str(tmp_path), resolutions=(16,),
                                            n_ens=1, years=0.001),
             lambda: pipeline.run_forcing_datasets(
                 str(tmp_path), n_runs=2, Nc=(8,), dns_nx=16, years=0.001),
             lambda: pipeline.run_parameterized(str(tmp_path), FOLDER),
             lambda: pipeline.coarsen(np.zeros((2, 16, 16)), "Operator1", 8),
             lambda: cli.main(["reference", "--nx", "16", "--subfolder",
                               str(tmp_path)]),
             lambda: first_bad_step(p, np.zeros((2, 16, 16)), 2, 1),
             lambda: dryrun_multichip(1)]
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


def _eager_dataset(p, closure, n_ens, steps_per_snap, n_snaps, key=0):
    """`run_ensemble`'s run, from the same start and generator seed, by the
    eager step loop: (Dataset, final carry)."""
    model, sampling, nsteps = closure["self"], closure["sampling"], \
        closure["nsteps"]
    q0 = torch.stack([simulate.set_initial_condition(p, key * 1000 + j)
                      for j in range(n_ens)])
    carry = init_run_carry(p, q0, key, model, device="cuda")
    step = make_online_step(p, model, sampling, nsteps)
    snaps = []
    for _ in range(n_snaps):
        for _ in range(steps_per_snap):
            carry = step(carry)
        snaps.append(simulate._snapshot(carry[0], p))
    snaps = {k: torch.stack([s[k] for s in snaps], 1).cpu().numpy()
             for k in snaps[0]}
    diags = {k: v.cpu().numpy() for k, v in
             simulate.diagnostics.finalize(carry[2]).items()}
    return simulate._build_dataset(snaps, diags, p, steps_per_snap * p.dt,
                                   n_snaps, run_dim=True), carry


@pytest.mark.cuda
@pytest.mark.parametrize("path,sampling,nsteps", [
    ("gan_k1", "AR1", -1), ("vae_k2", "AR1", -1),
    ("gan_k1", "constant", 3), ("gan_k1", "deterministic", 1)])
def test_graphed_run_equals_eager_loop_on_card(path, sampling, nsteps):
    """`run_ensemble` on the card replays captured graphs of its steady
    steps, with the path's chain kernel inside them (K1 for the GAN, K2's
    cooperative launch for the VAE), and equals the eager step loop bitwise:
    2 members x 32^2, 20 steps, so that the AB3 start, both diagnostics
    graphs and replays of each are crossed. With frozen noise (AR1, nsteps
    < 0) a wrapper counts one call a step run eagerly or captured; the
    constant sampler's draw and the deterministic sampler's fixed draws
    (the GAN's unfolded generator) are host branches and cached tensors
    that the graphs hold too."""
    _need_card()
    folder, kw, count = {"gan_k1": (FOLDER, {}, "launches"),
                         "vae_k2": (VAE, VAE_PATH, "launches_packed")}[path]
    model = load_model(folder, device="cuda", **kw)
    closure = {"self": model, "sampling": sampling, "nsteps": nsteps}
    p = QGParams(nx=32, dt=14400.0, tavestart=0.0, tmax=20 * 14400.0)
    ref, _ = _eager_dataset(p, closure, 2, 10, 2)
    before = (getattr(fused_conv, count), graph.eager_steps,
              graph.captured_steps, graph.replayed_steps)
    ds = run_ensemble(p, closure, n_ens=2, sampling_freq=10 * 14400.0,
                      device="cuda")
    calls, eager, captured, replayed = (
        a - b for a, b in zip((getattr(fused_conv, count), graph.eager_steps,
                               graph.captured_steps, graph.replayed_steps),
                              before))
    assert eager + replayed == 20 and captured >= 2 and replayed > eager
    if sampling == "AR1":
        assert calls == eager + captured
    assert sorted(ds.keys()) == sorted(ref.keys())
    for k in ref.keys():
        np.testing.assert_array_equal(ds[k].values, ref[k].values,
                                      err_msg=k)


@pytest.mark.cuda
def test_k2_counters_exist_before_capture_on_card(monkeypatch):
    """A graphed step on a new stream has K2's counter buffer for that
    stream allocated by its eager warm-up, never under capture; and a K2
    launch that would allocate it under capture raises."""
    _need_card()
    model = load_model(VAE, device="cuda", **VAE_PATH)
    allocations = []
    real = fused_conv._k2_counter_buffer

    def spy(device, stream):
        if (device.index, stream) not in fused_conv._k2_counters:
            allocations.append(torch.cuda.is_current_stream_capturing())
        return real(device, stream)

    monkeypatch.setattr(fused_conv, "_k2_counter_buffer", spy)
    p = QGParams(nx=32, dt=14400.0, tavestart=0.0)
    step = graph.GraphedStep(p, model, "AR1", 1)
    carry = init_run_carry(p, np.zeros((2, 2, 32, 32)), 0, model,
                           device="cuda")
    captured = graph.captured_steps
    for _ in range(8):
        carry = step(carry)
    torch.cuda.synchronize()
    assert graph.captured_steps > captured
    assert True not in allocations
    assert (carry[0].qh.device.index, step.stream.cuda_stream) \
        in fused_conv._k2_counters
    monkeypatch.setattr(fused_conv, "_k2_counter_buffer", real)
    packed = model._online_dec().packed
    x = torch.zeros((2, 32, 32, 128), device="cuda")
    stream = torch.cuda.Stream()
    while (x.device.index, stream.cuda_stream) in fused_conv._k2_counters:
        stream = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="under graph capture"):
        with torch.cuda.graph(g, stream=stream):
            fused_conv.packed_cnn_forward(x, packed)


def _seeded_folder(path, name, modules, **args):
    """A model folder written by the port on seeded weights of `modules`
    (file name -> module), with eddy_gan_64's scalers."""
    for i, (fname, module) in enumerate(modules.items()):
        save_variables(seeded_variables(module, 70 + i),
                       str(path / f"{fname}.msgpack"))
    for s in ("x_scale.json", "y_scale.json"):
        (path / s).write_text((pathlib.Path(FOLDER) / s).read_text())
    save_model_args(name, folder=str(path), **args)
    return str(path)


def _zoo_model(case, path):
    """(model on the card, the launch count its chain kernel adds to or
    None) of a closure of the zoo."""
    if case == "gan_opt_k1":
        model = load_model(GAN_OPT, device="cuda")
        assert model.use_optimal_epoch()
        return model, "launches"
    if case == "div_gan_k1":
        return load_model(_seeded_folder(
            path, "CGANRegression", {"G": nets.AndrewCNN(4, 2, div=True)},
            regression="None", nx=32, generator="Andrew", div=True),
            device="cuda"), "launches"
    if case == "bottleneck":
        return load_model(_seeded_folder(
            path, "CVAEBottleneck",
            {"deep_decoder": nets.Upsampling(100, 4, 2, nx=32),
             "decoder": nets.AndrewCNN(4, 2),
             "net_mean": nets.AndrewCNN(2, 2)}, nx=32), device="cuda"), None
    return physical.BackscatterEddy(device="cuda"), None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gan_opt_k1", "div_gan_k1", "physical",
                                  "bottleneck"])
def test_zoo_graphed_run_equals_eager_loop_on_card(case, tmp_path):
    """`run_ensemble` of a closure of this slice replays captured graphs and
    equals the eager step loop bitwise, AR1 white noise from one seed: the
    GAN's `opt` weights and a div=True GAN (its 4-wide chain through K1,
    then the divergence head), a physical closure (u, v and psi, no noise)
    and the bottleneck VAE (a flat latent of 100 a member, drawn every
    step). 2 members x 32^2, 20 steps; a kernel wrapper counts one call a
    step run eagerly or captured."""
    _need_card()
    model, count = _zoo_model(case, tmp_path)
    closure = {"self": model, "sampling": "AR1", "nsteps": 1}
    p = QGParams(nx=32, dt=14400.0, tavestart=0.0, tmax=20 * 14400.0)
    ref, _ = _eager_dataset(p, closure, 2, 10, 2)
    read = (lambda: (getattr(fused_conv, count) if count else 0,
                     graph.eager_steps, graph.captured_steps,
                     graph.replayed_steps))
    before = read()
    ds = run_ensemble(p, closure, n_ens=2, sampling_freq=10 * 14400.0,
                      device="cuda")
    calls, eager, captured, replayed = (a - b for a, b in zip(read(),
                                                              before))
    assert eager + replayed == 20 and captured >= 2 and replayed > eager
    if count:
        assert calls == eager + captured
    assert np.isfinite(ds["q"].values).all()
    for k in ref.keys():
        np.testing.assert_array_equal(ds[k].values, ref[k].values,
                                      err_msg=k)


@pytest.mark.cuda
def test_graphed_step_recaptures_after_switch_on_card():
    """A GraphedStep held across `use_optimal_epoch` drops its graphs and
    captures anew from the new weights: it never replays a graph of the old
    ones, and after the switch it equals the eager step loop that switched
    at the same step, bitwise (frozen noise, 2 members x 32^2)."""
    _need_card()
    p = QGParams(nx=32, dt=14400.0, tavestart=0.0)
    q0 = np.stack([core.default_initial_q(
        p, rng=np.random.default_rng(j)).numpy() for j in range(2)])

    def run(graphed):
        model = load_model(GAN_OPT, device="cuda")
        carry = init_run_carry(p, q0, 0, model, device="cuda")
        step = graph.GraphedStep(p, model, "AR1", -1) if graphed \
            else make_online_step(p, model, "AR1", -1)
        for _ in range(8):
            carry = step(carry)
        captured = graph.captured_steps
        assert model.use_optimal_epoch()
        for _ in range(8):
            carry = step(carry)
        return carry[0].qh.clone(), graph.captured_steps - captured, step

    eager, _, _ = run(False)
    graphed, recaptured, step = run(True)
    assert recaptured >= 1 and step._generation == step.model \
        .weights_generation
    assert torch.equal(graphed, eager)


def _program_inputs(model, nx, B=3, M=8):
    """Seeded normalised PV (B, nx, nx, 2) and M latent draws, on the
    CPU."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, nx, nx, 2)).astype(np.float32)
    zs = rng.standard_normal((M, B) + tuple(model.latent_shape(nx, nx))
                             ).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(zs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gan", "gan_bf16", "vae_packed", "gz"])
def test_offline_predict_on_card_matches_cpu(case):
    """Each CNN closure's offline program on the card against the same on
    the CPU (the kernels' plain versions): the GAN (K1 in float32, also for
    a model whose online dtype is bf16) and the VAE with "packed" (K2) by
    their mean and variance over 8 draws handed to both, in chunks of 3, 3
    and 2 (chunks of 3 x 3 = 9 images through the kernel); the GZ by its
    `predict` on a dataset (K1 on each net, its numpy sample). rtol 2e-4 /
    atol 2e-5*max|ref|, float32 sums in another order; the variance's atol
    is that of the mean squared, which its formula cancels."""
    _need_card()
    folder, kw, count = {
        "gan": (FOLDER, {}, "launches"),
        "gan_bf16": (FOLDER, {"inference_dtype": "bfloat16"}, "launches"),
        "vae_packed": (VAE, VAE_PATH, "launches_packed"),
        "gz": (GZ, GZ_PATH, "launches")}[case]
    card = load_model(folder, device="cuda", **kw)
    cpu = load_model(folder, device="cpu", **kw)
    before = getattr(fused_conv, count)
    if case == "gz":
        ds = xr.Dataset()
        q = np.random.default_rng(22).standard_normal((2, 3, 2, 16, 16))
        ds["q"] = xr.DataArray((1e-5 * q).astype(np.float32),
                               ("run", "time", "lev", "y", "x"))
        out, ref = card.predict(ds), cpu.predict(ds)
        torch.cuda.synchronize()
        assert getattr(fused_conv, count) == before + 2
        pairs = [(out[k].values, ref[k].values) for k in ref.keys()]
    else:
        x, zs = _program_inputs(cpu, 16)
        chunks = ((0, 3), (3, 6), (6, 8))
        out = card._mean_var_program(8)(
            x.cuda(), [zs[a:b].cuda() for a, b in chunks])
        ref = cpu._mean_var_program(8)(x, [zs[a:b] for a, b in chunks])
        torch.cuda.synchronize()
        assert getattr(fused_conv, count) == before + 3
        pairs = [(o.cpu().numpy(), r.numpy()) for o, r in zip(out, ref)]
        pairs[2] = (pairs[2][0], pairs[2][1], np.max(pairs[1][1] ** 2))
    for pair in pairs:
        o, r = pair[:2]
        scale = pair[2] if len(pair) == 3 else np.abs(r).max()
        np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.cuda
def test_forcing_graphed_dns_equals_eager_on_card(monkeypatch):
    """The forcing generator on the card replays captured graphs of its DNS
    steps, and its datasets equal those of the same run with the eager step
    in place of the graph, bitwise: 32^2 in float64 (the twin's test
    precision), 2 snapshots of 10 steps, Operator2 and Operator5 to 16^2."""
    _need_card()
    p = QGParams(nx=32, dt=3600.0, tmax=20 * 3600.0, precision="double")
    replayed = graph.replayed_steps
    graphed = generate_subgrid_forcing([16], p, sampling_freq=10 * 3600.0,
                                       device="cuda")
    assert graph.replayed_steps - replayed >= 10
    monkeypatch.setattr(simulate.graph, "GraphedStep",
                        lambda p, model, with_diags: make_online_step(
                            p, model, with_diags=with_diags))
    eager = generate_subgrid_forcing([16], p, sampling_freq=10 * 3600.0,
                                     device="cuda")
    assert sorted(graphed) == sorted(eager) == ["Operator2-16-dealias",
                                                "Operator5-16-dealias"]
    for combo in eager:
        for k in eager[combo].keys():
            np.testing.assert_array_equal(graphed[combo][k].values,
                                          eager[combo][k].values,
                                          err_msg=f"{combo} {k}")


@pytest.mark.cuda
def test_gan_batch_step_on_card_matches_cpu():
    """One GAN batch step (critic and generator, i = 0) on the card in
    float32 against the CPU in float64, on the same seeded weights, batch
    and draws: each loss to relative 1e-5 and each gradient tensor to
    relative RMS 1e-4. The step runs PyTorch's own convolutions
    (`device.exact_fp32_training`): no chain kernel launches."""
    _need_card()
    from pyqg_generative_torch.ml.train import named_params
    from pyqg_generative_torch.ml.weights import params_from_jax
    from pyqg_generative_torch.models import cgan_regression as gan
    rng = np.random.default_rng(5)
    nx, B = 32, 4
    arrays = [rng.standard_normal((B, nx, nx, 2)) for _ in range(2)] + \
        [np.zeros((B, nx, nx, 2))] + \
        [rng.standard_normal((B, nx, nx, 2)) for _ in range(2)] + \
        [rng.random((B, 1, 1, 1)), np.asarray(True)]
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = CGANRegression(nx=nx, folder="missing", device=dev,
                           hidden_channels=(32, 16))
        for module, seed in ((m.G, 1), (m.D, 2)):
            module.load_state_dict(params_from_jax(seeded_variables(
                module, seed)))
            module.to(dtype)
        t = [torch.as_tensor(a, device=dev, dtype=dtype if a.dtype != bool
                             else torch.bool) for a in arrays]
        txG, txD = gan.gan_optimizers(2e-4, 2, 3)
        opt = {"G": txG.init(named_params(m.G)),
               "D": txD.init(named_params(m.D))}
        grads = {}
        before = fused_conv.launches
        metrics = gan.make_gan_batch_step(m, txG, txD)(
            opt, tuple(t[:3]), True, tuple(t[3:]), grads=grads)
        assert fused_conv.launches == before
        out[dev] = metrics, grads
    (mc, gc), (mr, gr) = out["cuda"], out["cpu"]
    for k in mr:
        assert abs(float(mc[k]) / float(mr[k]) - 1) < 1e-5, k
    for net in ("D", "G"):
        for k, g in gr[net].items():
            assert _rel_rms(gc[net][k].double().cpu(), g) <= 1e-4, (net, k)


@pytest.mark.cuda
def test_gan_ensemble_replica_equals_fit_on_card(tmp_path):
    """Two GAN replicas trained in lockstep on the card (8-wide nets at
    16^2, 2 epochs, the offline evaluation through K1) end bitwise as their
    own fits with the same keys: every module tensor, G_opt.msgpack and
    stats.npz."""
    _need_card()
    from pyqg_generative_torch.ml.multifit import fit_gan_ensemble
    rng = np.random.default_rng(7)

    def data(nrun, ntime):
        q = rng.standard_normal((nrun, ntime, 2, 16, 16)) * 1e-5
        ds = xr.Dataset()
        for k, v in (("q", q), ("q_forcing_advection", 2e-6 * q + 1e-12 *
                                rng.standard_normal(q.shape)),
                     ("psi", 1e2 * rng.standard_normal(q.shape))):
            ds[k] = xr.DataArray(v.astype("float32"),
                                 ("run", "time", "lev", "y", "x"))
        return ds

    ds_train, ds_test = data(4, 8), data(2, 4)

    def make(folder):
        m = CGANRegression(nx=16, folder="missing", device="cuda",
                           hidden_channels=(8,))
        m.D = nets.DCGANDiscriminator(6, ndf=8, nx=16).cuda()
        m.folder = str(folder)
        return m

    fit_kw = dict(num_epochs=2, batch_size=16, nruns=1, verbose=False)
    singles = []
    for key in (0, 1):
        m = make(tmp_path / f"s{key}")
        m.fit(ds_train, ds_test, key=key, **fit_kw)
        singles.append(m)
    replicas = [make(tmp_path / f"r{key}") for key in (0, 1)]
    before = fused_conv.launches
    fit_gan_ensemble(replicas, [ds_train] * 2, [ds_test] * 2, keys=(0, 1),
                     **fit_kw)
    assert fused_conv.launches > before
    for m, r in zip(singles, replicas):
        for name in ("G", "D"):
            a, b = getattr(m, name).state_dict(), getattr(r, name).state_dict()
            for k in a:
                assert torch.equal(a[k], b[k]), (name, k)
        for f in ("G_opt.msgpack", "stats.npz"):
            assert (pathlib.Path(m.folder) / f).read_bytes() == \
                (pathlib.Path(r.folder) / f).read_bytes(), f


@pytest.mark.cuda
def test_native_loader_feeds_the_card_through_pinned_buffers(tmp_path):
    """fit_streaming on the card from the native loader, two pinned
    buffers: every epoch's batches reach the card whole (the tags of each
    epoch cover every sample once, plus the wrapped last batch), recorded on
    the card without a sync; and its losses match the same run on the CPU
    (float32, the numpy loader in both) to 1e-5."""
    _need_card()
    from pyqg_generative_torch.models.common import mse_loss_fn
    from pyqg_generative_torch.ml import train as T
    from pyqg_generative_torch.utils.native import FastLoader, \
        write_sample_store
    rng = np.random.default_rng(0)
    X = rng.standard_normal((100, 16, 16, 2)).astype(np.float32)
    X[:, 0, 0, 0] = np.arange(100)
    write_sample_store(str(tmp_path), {"x": X, "y": 0.5 * X})

    def run(device, loader):
        net = nets.AndrewCNN(2, 2, hidden_channels=(8,), batch_norm=False)
        net.load_state_dict(params_from_jax(seeded_variables(net, 2)))
        net = net.to(device)
        tx = T.multistep_adam(1e-3, 2, 7)
        seen = []

        def loss_fn(batch, train):
            seen.append(batch[0][:, 0, 0, 0].clone())
            return mse_loss_fn(net)(batch, train)

        state = T.TrainingState(net, tx.init(T.named_params(net)))
        _, log = T.fit_streaming(loss_fn, state, tx, loader, ("x", "y"), 2,
                                 verbose=False)
        return log["loss"], torch.cat(seen).cpu().numpy().astype(int)

    loader = FastLoader(str(tmp_path), batch_size=16)
    assert loader.native
    _, tags = run("cuda", loader)
    for epoch in tags.reshape(2, -1):
        assert sorted(epoch[:100]) == list(range(100))
        assert list(epoch[100:]) == list(epoch[:12])
    loss_card, _ = run("cuda", FastLoader(str(tmp_path), batch_size=16,
                                          force_python=True))
    loss_cpu, _ = run("cpu", FastLoader(str(tmp_path), batch_size=16,
                                        force_python=True))
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-5)


@pytest.mark.cuda
def test_one_rank_sharded_ensemble_is_bitwise_on_card():
    """run_ensemble of eddy_gan_64 with ensemble_sharding over a 1-rank NCCL
    group equals the unsharded run bitwise (2 members x 64^2, AR1,
    diagnostics on, graphed), and launches K1."""
    _need_card()
    import torch.distributed as dist
    from pyqg_generative_torch.parallel import ensemble_sharding, make_mesh
    from pyqg_generative_torch.parallel.spawn import free_port
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        p = QGParams(nx=64, dt=14400.0, tmax=8 * 14400.0, tavestart=0.0)
        closure = {"self": load_model(FOLDER, device="cuda"),
                   "sampling": "AR1", "nsteps": 1}
        kw = dict(n_ens=2, sampling_freq=4 * 14400.0, device="cuda")
        before = fused_conv.launches
        ds = run_ensemble(p, closure, sharding=ensemble_sharding(
            make_mesh()), **kw)
        assert fused_conv.launches > before
        ref = run_ensemble(p, closure, **kw)
        assert sorted(ds.keys()) == sorted(ref.keys())
        for k in ref.keys():
            assert np.array_equal(ds[k].values, ref[k].values), k
    finally:
        dist.destroy_process_group()
