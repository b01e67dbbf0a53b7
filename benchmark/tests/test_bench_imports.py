"""What the benchmark imports: the reference nothing of the port, of the
JAX package or of JAX; the harness no JAX; and the no-JAX guard compares
top-level names whole."""
import ast

from conftest import ROOT

from benchmark import guard

BENCH = ROOT / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(names):
    return {n.split(".", 1)[0] for n in names}


def test_reference_imports_nothing_of_the_port_or_jax():
    files = list((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        tops = _top(_imports(path))
        assert not tops & {"pyqg_generative_torch", "pyqg_generative_tpu",
                           "jax", "jaxlib", "flax", "optax", "benchmark"}, \
            path.name


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _top(_imports(path)) & set(guard.FORBIDDEN), path.name


def test_guard_compares_whole_top_level_names():
    names = ["pyqg_generative_torch", "pyqg_generative_torch.sim",
             "jaxtyping", "flaxen.x", "optaxx", "torch", "numpy"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["jax.numpy"]) == ["jax"]
    assert guard.forbidden_modules(
        ["pyqg_generative_tpu.qg.core", "jaxlib", "flax", "optax"]) == \
        ["flax", "jaxlib", "optax", "pyqg_generative_tpu"]


def test_a_benchmark_process_loads_no_jax():
    """Both cells run at 16^2 on the CPU in a fresh process, which then
    holds no forbidden module."""
    import subprocess
    import sys
    script = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "benchmark" / "tests")!r}]
from types import SimpleNamespace
import torch
from conftest import shrink_config, shrink_traffic
from benchmark import guard, manifest, run
config, traffic = manifest.config, manifest.traffic
manifest.config = lambda *a, **k: shrink_config(config(*a, **k))
manifest.traffic = lambda *a, **k: shrink_traffic(traffic(*a, **k))
for cell in ("gan64_online", "vae64_train"):
    args = SimpleNamespace(workload=cell, seed=5, seconds=0.1, trace=0)
    assert run.run(args, torch.device("cpu"), manifest.load())["correct"]
print(guard.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
