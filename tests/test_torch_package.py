"""Rules of the PyTorch port as a package: it never imports the JAX stack,
its entry points refuse to fall back to the CPU unasked, importing it builds
nothing, and its kernel agrees with its plain version on the card. This file
imports no JAX, so that the card's test runs where JAX is not installed:
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
from pyqg_generative_torch.models import CGANRegression, \
    Parameterization, load_model
from pyqg_generative_torch.qg import core
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.sim import run_ensemble
from pyqg_generative_torch.sim.stochastic import init_sampler

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pyqg_generative_tpu"}
FOLDER = str(ROOT / "trained_models" / "eddy_gan_64")


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
    monkeypatch.setenv("PATH", "")
    importlib.reload(_build)
    importlib.reload(fused_conv)
    assert _build._LOADED == {} and fused_conv.launches == 0
    folded = {"params": {f"Conv_{i}": {
        "kernel": np.full((3, 3, 2, 2), 0.1, np.float32),
        "bias": np.zeros(2, np.float32)} for i in range(2)}}
    packed = fused_conv.pack_folded_params(folded, "cpu")
    out = fused_conv.fused_cnn_forward(torch.ones(1, 8, 8, 2), packed)
    assert out.shape == (1, 8, 8, 2) and fused_conv.launches == 0
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
