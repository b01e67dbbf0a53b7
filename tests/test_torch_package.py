"""Rules of the PyTorch port as a package: it never imports the JAX stack,
its entry points refuse to fall back to the CPU unasked, importing it builds
nothing, its models route through the kernels' wrappers, and each kernel
agrees with its plain version on the card. This file imports no JAX, so that
the card's tests run where JAX is not installed:
python -m pytest tests/test_torch_package.py -m cuda --noconftest"""
import ast
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
    out = fused_conv.packed_cnn_forward(torch.ones(64, 2), packed)
    assert out.shape == (64, 2)
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
    through K2's once a call, member-packed. Spies count the calls on the
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
    assert calls == [("packed_cnn_forward", (256, 3 * 128), torch.float32)]


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
    kernel's 16^2 tile. rtol 2e-4, atol 2e-5*max: float32 sums in another
    order (the bar of tests/test_pallas_conv.py:49)."""
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


@pytest.mark.cuda
def test_k1_bf16_matches_plain_on_card():
    """K1-bf16 against its plain version on the merged GZ pair at path 2's
    shapes (10 x 64^2, 256 channels in) and on a toy chain over a grid that
    is no multiple of the 16^2 tile. Relative RMS <= 1e-3: the two differ
    only where a float32 sum taken in another order flips a bf16 rounding."""
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
        before = fused_conv.launches_bf16
        out = fused_conv.fused_cnn_forward(x, packed)
        torch.cuda.synchronize()
        assert fused_conv.launches_bf16 == before + 1
        ref = fused_conv.fused_cnn_forward_plain(x, packed)
        assert _rel_rms(out, ref) <= 1e-3


def _to_nhwc(x, B, H):
    """Member-packed (H*H, B*C) -> (B, H, H, C)."""
    return x.reshape(H, H, B, -1).permute(2, 0, 1, 3).contiguous()


def _from_member_packed(y):
    """(B, H, W, C) -> member-packed (H*W, B*C)."""
    B, H, W, C = y.shape
    return y.permute(1, 2, 0, 3).reshape(H * W, B * C)


@pytest.mark.cuda
def test_k2_matches_plain_on_card():
    """K2 against its plain version (one roll and one matmul per tap) on the
    VAE decoder at path 3's shapes (10 x 64^2) and on random widths at
    3 x 48^2, float32: rtol 2e-4, atol 2e-5*max (sums in another order).
    In bf16 on the decoder: relative RMS <= 1e-3 against K1's plain version,
    which sums in the kernel's order. K2's own plain version sums in another
    order, so bf16 roundings flip and cascade (relative RMS 4.1e-3 read on
    an H100); it is no bf16 reference."""
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
            (H * H, B * 128))).astype(np.float32)).cuda()
        before = fused_conv.launches_packed
        out = fused_conv.packed_cnn_forward(x, packed)
        torch.cuda.synchronize()
        assert fused_conv.launches_packed == before + 1
        if dtype == torch.bfloat16:
            k1 = _from_member_packed(fused_conv.fused_cnn_forward_plain(
                _to_nhwc(x, B, H), packed))
            assert _rel_rms(out, k1) <= 1e-3
        else:
            ref = fused_conv.packed_cnn_forward_plain(x, packed)
            np.testing.assert_allclose(
                out.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4,
                atol=2e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_k3_matches_plain_on_card():
    """K3's words equal its plain version's exactly, on the probe's input
    and on random bf16, and the card packs bf16 pairs 'adj_low'."""
    _need_card()
    x = torch.randn((8, 128), generator=torch.Generator().manual_seed(12)
                    ).to(torch.bfloat16)
    before = fused_conv.launches_probe
    words = fused_conv.bitcast_pack_words(x.cuda()).cpu()
    assert fused_conv.launches_probe == before + 1
    assert torch.equal(words, fused_conv.bitcast_pack_words_plain(x))
    fused_conv.bitcast_packing.cache_clear()
    assert fused_conv.bitcast_packing("cuda") == "adj_low"
