"""The VAE's training step replayed from a CUDA graph
(`ml/train_graph.py::GraphedTrainStep` behind `VaeTrainer.step`), the
capture-and-replay core under it and under the online step
(`utils/step_graphs.py::StepGraphs`), and Adam's scalars as device tensors
(`ml/train.py::Adam`).

On the CPU: the core's sequence of eager steps, captures and replays, its
counters and spans (its CUDA calls stood in for); a `VaeTrainer` steps
eagerly (the counters read eager steps only) and hands out fresh metrics;
`load` copies into the trainer's own tensors; Adam with its scalars as
tensors is bitwise the update written with Python floats; both graphed
steps refuse CPU inputs; the benchmark's `train.replayed_share` reader on
hand-built traces. On the card (imports no jax): python -m pytest
tests/test_torch_train_graph.py -m cuda --noconftest. There, at the
`vae64_train` cell's shapes (batch 64 at 64^2, published widths, fresh
weights from one seed), 12 graphed steps across an epoch's end are bitwise
an eager step written out in this file (`make_vae_loss`,
`torch.autograd.grad`, Adam with Python floats) over a twin trainer's
modules and state, a carry()/load() round trip between replays stays
bitwise, the bottleneck VAE's step is bitwise too, Adam's tensors are
bitwise Python floats at parameters small enough to show an update's last
bit, and a capture that meets a host read raises.
"""
import contextlib
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pyqg_generative_torch.device import exact_fp32_training
from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml import train as tt
from pyqg_generative_torch.ml.train_graph import COUNTERS, GraphedTrainStep
from pyqg_generative_torch.models import CVAEBottleneck, CVAERegression
from pyqg_generative_torch.models.cvae_regression import VaeTrainer, \
    make_vae_loss, vae_eps, vae_params
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.sim import init_run_carry
from pyqg_generative_torch.sim.graph import GraphedStep
from pyqg_generative_torch.utils import debugging, profiling
from pyqg_generative_torch.utils.step_graphs import StepGraphs

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import manifest, tracing  # noqa: E402

torch.set_num_threads(1)

MISSING = "/nonexistent_model_folder"
CUDA = pytest.param("cuda", marks=pytest.mark.cuda)


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


def _counts() -> dict:
    c = profiling.counters()
    return {k: c.get(v, 0) for k, v in COUNTERS.items()}


def _small_trainer(n=20, batch=8):
    net = CVAERegression(folder=MISSING, device="cpu", hidden_channels=(8,))
    net.encoder = tnets.AndrewCNN(4, 4, hidden_channels=(8,))
    g = torch.Generator().manual_seed(0)
    X, Y = (torch.randn(n, 16, 16, 2, generator=g) for _ in range(2))
    return VaeTrainer(net, (X, Y, torch.zeros_like(Y)), 2, batch, 1e-3, 0)


# ------------------------------------------------------------------- CPU
def test_cpu_trainer_steps_eagerly_with_fresh_metrics():
    trainer = _small_trainer()
    assert trainer.graphed is None
    profiling.reset_counters()
    perm = trainer.batches()
    first = trainer.step(0, perm[0])
    kept = {k: v.clone() for k, v in first.items()}
    second = trainer.step(1, perm[1])
    assert _counts() == {"eager_steps": 2, "captured_steps": 0,
                         "replayed_steps": 0}
    assert list(first) == ["loss", "loss_recon", "loss_KL", "MSE",
                           "var_latent", "var_aggr"]
    for k in first:
        assert torch.equal(first[k], kept[k]), k
        assert first[k].data_ptr() != second[k].data_ptr(), k
    assert trainer.opt_state["count"] == 2


def test_load_copies_into_the_trainers_tensors():
    trainer = _small_trainer()
    perm = trainer.batches()
    trainer.step(0, perm[0])
    saved = {"modules": {k: {n: t.clone() for n, t in sd.items()}
                         for k, sd in trainer.carry()["modules"].items()},
             "opt": {"count": trainer.opt_state["count"],
                     **{part: {n: t.clone() for n, t in
                               trainer.opt_state[part].items()}
                        for part in ("mu", "nu")}}}
    params = dict(trainer.net.encoder.named_parameters())
    moments = dict(trainer.opt_state["mu"])
    state = trainer.opt_state
    trainer.step(1, perm[1])
    trainer.load(saved)
    assert trainer.opt_state is state and state["count"] == 1
    for n, p in trainer.net.encoder.named_parameters():
        assert p is params[n]
        assert torch.equal(p, saved["modules"]["enc"][n])
    for n, t in state["mu"].items():
        assert t is moments[n] and torch.equal(t, saved["opt"]["mu"][n])


def _python_float_adam(tx, params, grads, state):
    """Adam's update as written with Python floats (the arithmetic that
    `Adam.step` keeps bitwise)."""
    b1, b2 = tx.b1, tx.b2
    count = state["count"]
    step_size = -tx.learning_rate(count)
    bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
    with torch.no_grad():
        for (name, p), g in zip(params.items(), grads):
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + tx.eps)
            p.copy_(p + step_size * update)
    state["count"] = count + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("device", ["cpu", CUDA])
def test_adam_scalars_as_tensors_are_bitwise_python_floats(device, dtype):
    """30 updates through the schedule's boundaries (at 10 and 15) and the
    bias corrections' approach to 1, on gradients of 1e-8 to 10, of
    parameters that start at 0 or as small as the closures' (0.02), where
    an update's last bit shows in the parameter."""
    dev = _device(device)
    g = torch.Generator().manual_seed(0)
    shapes = [(7,), (3, 5), (4, 2, 3, 3), (64, 16)]
    a = {f"p{i}": (torch.randn(s, generator=g, dtype=dtype) * 0.02 * i
                   ).to(dev) for i, s in enumerate(shapes)}
    b = {k: v.clone() for k, v in a.items()}
    tx = tt.multistep_adam(1e-3, 4, 5)
    sa, sb = tx.init(a), tx.init(b)
    for step in range(30):
        scale = 10.0 ** float(torch.randint(-8, 2, (), generator=g))
        grads = [(torch.randn(s, generator=g, dtype=dtype) * scale).to(dev)
                 for s in shapes]
        tx.step(a, grads, sa)
        _python_float_adam(tx, b, grads, sb)
        for k in a:
            assert torch.equal(a[k], b[k]), (step, k)
            assert torch.equal(sa["mu"][k], sb["mu"][k]), (step, k)
            assert torch.equal(sa["nu"][k], sb["nu"][k]), (step, k)
    assert sa["count"] == sb["count"] == 30


def _online_step_on_cpu():
    p = QGParams(nx=16)
    return GraphedStep(p, with_diags=False), (init_run_carry(
        p, np.zeros((1, 2, 16, 16)), 0, with_diags=False, device="cpu"),)


STEPS_ON_CPU = {
    "GraphedTrainStep": lambda: (GraphedTrainStep(lambda x: {"s": x.sum()}),
                                 (torch.zeros(3),)),
    "GraphedStep": _online_step_on_cpu,
}


@pytest.mark.parametrize("wrapper", sorted(STEPS_ON_CPU))
def test_graphed_step_needs_cuda_inputs(wrapper):
    step, inputs = STEPS_ON_CPU[wrapper]()
    with pytest.raises(ValueError, match="CUDA"):
        step(*inputs)


class _Graph:
    """Stands in for torch.cuda.CUDAGraph: without keep_graph, instantiated
    at the capture's end, as CUDA's is."""
    made: list = []

    def __init__(self, keep_graph=False):
        self.keep, self.generators, self.replays = keep_graph, [], 0
        self.ready = self.captured = False
        _Graph.made.append(self)

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def instantiate(self):
        assert self.keep and self.captured and not self.ready
        self.ready = True

    def replay(self):
        assert self.ready
        self.replays += 1


@contextlib.contextmanager
def _capturing(graph, pool=None, stream=None):
    assert pool == "pool" and not graph.captured
    yield
    graph.captured, graph.ready = True, not graph.keep


# warm-up, then each call's key ("!" runs it under debug_nans; "reset"
# resets) and how it runs: Eager, Captured (and replayed) or Replayed
CORE = {
    "warm-up 3 across two keys": (3, "a:E b:E a:E b:C a:C b:R a:R b:R"),
    "warm-up 1": (1, "a:E a:C a:R b:E b:C b:R"),
    "debug_nans forces eager": (1, "a:E !a:E a:C !a:E a:R"),
    "reset": (1, "a:E a:C reset a:E a:C a:R"),
    # the GAN's 11 checked steps, keyed by the branch (g: the generator
    # updates too, i % 5 == 0; c: the critic alone)
    "a GAN period, the branch in the key": (
        1, "g:E c:E c:C c:R c:R g:C c:R c:R c:R c:R g:R"),
}


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("case", sorted(CORE))
def test_step_graphs_sequence(case, checked, monkeypatch):
    """`StepGraphs.run`'s eager steps, captures and replays for a sequence
    of keys, its counters (a capture counts as captured and as replayed,
    so eager + replayed are the calls) and spans (none on a replay), its
    generators registered with every graph, what a graph keeps (the body's
    arguments, tensors cloned, and its output), and `on_capture`, which
    alone keeps the graph and runs once a capture with the counters from
    before it."""
    monkeypatch.setattr(_Graph, "made", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "graph", _capturing)
    warmup, calls = CORE[case]
    generator = torch.Generator()
    checks = []

    def on_capture(g, before):
        assert g.graph.ready and g not in core.graphs.values()
        checks.append((g, before))
    core = StepGraphs("core_test", warmup, (generator,),
                      on_capture if checked else None)
    names = {k: f"core_test.{k}" for k in ("eager_steps", "captured_steps",
                                          "replayed_steps")}
    before = profiling.counters()
    profiling.clear_spans()
    got, ran = [], []

    def body(k, x):
        ran.append(k)
        return "E" if _Graph.made == [] or _Graph.made[-1].captured \
            else k.upper()

    def replay(g, k, x):
        assert g.inputs[0] == k and g.out == k.upper()
        assert torch.equal(g.inputs[1], x) and g.inputs[1] is not x
        g.graph.replay()
        return "C" if g.graph.replays == 1 else "R"
    for call in calls.split():
        if call == "reset":
            core.reset()
            got.append(call)
            continue
        key = call[:-2].lstrip("!")
        with debugging.debug_nans() if call.startswith("!") \
                else contextlib.nullcontext():
            how = core.run(key, body, (key, torch.ones(2)), replay)
        got.append(f"{call[:-2]}:{how}")
    assert " ".join(got) == calls
    n = {how: sum(c.endswith(how) for c in got) for how in "ECR"}
    after = profiling.counters()
    delta = {k: after[v] - before.get(v, 0) for k, v in names.items()}
    assert delta == {"eager_steps": n["E"], "captured_steps": n["C"],
                     "replayed_steps": n["C"] + n["R"]}
    assert len(ran) == n["E"] + n["C"]
    spans = [s.name for s in profiling.spans()]
    assert sorted(spans) == sorted(
        ["core_test.eager"] * n["E"] + ["core_test.capture"] * n["C"]
        + ["core_test.reset"] * calls.split().count("reset"))
    assert len(_Graph.made) == n["C"]
    assert all(g.generators == [generator] and g.keep == checked
               for g in _Graph.made)
    assert sum(g.replays for g in _Graph.made) == n["C"] + n["R"]
    assert [g.graph for g, _ in checks] == (_Graph.made if checked else [])
    assert all(isinstance(b, dict) for _, b in checks)


def _trace(host):
    window = (0.0, 1000.0)
    return tracing.Trace(device=[("k", 0.0, 1000.0)],
                         host=[(tracing.MARK,) + window] + host,
                         window=window)


REPLAYED = {
    "all replayed": ([("train.step", 0, 300), ("train.replay", 10, 290),
                      ("train.step", 400, 700), ("train.replay", 410, 690),
                      ("cudaGraphLaunch", 420, 430)], 100.0),
    "eager steps": ([("train.step", 0, 300), ("train.forward", 10, 100),
                     ("train.optimizer", 200, 290),
                     ("train.step", 400, 700)], 0.0),
    "no train.step spans": ([("sim.run_ensemble", 0, 900),
                             ("graph.capture", 10, 20)], None),
}


@pytest.mark.parametrize("case", sorted(REPLAYED))
def test_replayed_share_reader(case):
    host, want = REPLAYED[case]
    ctx = SimpleNamespace(trace=_trace(host), work={"batches": 2},
                          counters={}, config={}, traffic={})
    assert manifest.reader("train.replayed_share")(ctx) == want


# ------------------------------------------------------------------ card
def _state(trainer) -> dict:
    out = {}
    for mod, m in trainer.net._vae_modules().items():
        for k, v in m.state_dict().items():
            out[f"{mod}.{k}"] = v.detach().clone()
    for part in ("mu", "nu"):
        for k, v in trainer.opt_state[part].items():
            out[f"{part}.{k}"] = v.clone()
    return out


def _cell_data(dev, n):
    """n standard normal samples of the cell's (x, y) at 64^2, ymean 0."""
    g = torch.Generator(device=dev).manual_seed(7)
    data = tuple(torch.randn((n, 64, 64, 2), generator=g, device=dev)
                 for _ in range(2))
    return data + (torch.zeros_like(data[1]),)


def _cell_trainer(data, key=2147500111):
    """The cell's sigma-VAE (published widths, 64^2) from fresh weights
    drawn from `key`, on `data`."""
    net = CVAERegression(folder=MISSING, device=data[0].device)
    return VaeTrainer(net, data, 200, 64, 2e-4, key=key)


class _Eager:
    """A VAE step written out here, on a trainer's modules, Adam state,
    schedule and generator and on its data, apart from `VaeTrainer.step`,
    `make_vae_step` and `Adam.step`: `make_vae_loss` in train mode,
    `torch.autograd.grad` and Adam with Python floats, under
    `exact_fp32_training` as the trainer's step runs."""

    def __init__(self, trainer, data):
        self.trainer, self.data = trainer, data
        self.loss_fn = make_vae_loss(trainer.net)
        self.params = vae_params(trainer.net)
        self.opt_state = trainer.opt_state
        self.batches = trainer.batches

    def step(self, i, idx):
        t = self.trainer
        batch = tuple(d[idx] for d in self.data)
        eps = vae_eps(t.generator, t.net, batch[0])
        with exact_fp32_training():
            loss, metrics = self.loss_fn(*batch, eps, True)
            grads = torch.autograd.grad(loss, list(self.params.values()))
            _python_float_adam(t.tx, self.params, grads, t.opt_state)
        return {k: v.detach() for k, v in metrics.items()}


def _assert_same(a: dict, b: dict, what):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.cuda
def test_graphed_vae_steps_are_bitwise_the_eager_ones_on_card():
    """12 steps (6 batches an epoch, so an epoch's end at step 6) of the
    graphed trainer and of `_Eager` on a twin trainer, from the same
    weights and rows: every metric, parameter, BatchNorm statistic and Adam
    moment bitwise at every step; 1 eager, 1 captured and 11 replayed
    steps (the capture's replay counted); each step's metrics unchanged by
    the next step."""
    dev = _device("cuda")
    data = _cell_data(dev, 5 * 64 + 10)
    graphed = _cell_trainer(data)
    twin = _cell_trainer(data)
    eager = _Eager(twin, data)
    assert graphed.graphed is not None
    _assert_same(_state(graphed), _state(twin), "fresh weights")
    profiling.reset_counters()
    perms, rows, kept = [graphed.batches(), graphed.batches()], [], None
    for perm in perms:
        for i in range(len(perm)):
            m = graphed.step(i, perm[i])
            torch.cuda.synchronize()
            if kept is not None:  # the step before's, after this step
                _assert_same(rows[-1][0], kept, "metrics of the step before")
            kept = {k: v.clone() for k, v in m.items()}
            rows.append((m, graphed.opt_state["count"], _state(graphed)))
    assert len(rows) == 12
    assert _counts() == {"eager_steps": 1, "captured_steps": 1,
                         "replayed_steps": 11}
    i = 0
    for perm in perms:
        assert torch.equal(eager.batches(), perm)
        for j in range(len(perm)):
            m = eager.step(j, perm[j])
            torch.cuda.synchronize()
            want_m, want_count, want_state = rows[i]
            _assert_same(m, want_m, f"metrics, step {i}")
            assert eager.opt_state["count"] == want_count == i + 1
            _assert_same(_state(twin), want_state, f"state, step {i}")
            i += 1


@pytest.mark.cuda
def test_carry_and_load_between_replays_stay_bitwise_on_card():
    """A graphed trainer saves its carry and generator after 6 steps, runs
    2 more, loads them back and runs the last 6 again (replays on the
    copied-in tensors): bitwise 12 steps of `_Eager` on a twin trainer."""
    dev = _device("cuda")
    data = _cell_data(dev, 6 * 64)
    graphed = _cell_trainer(data)
    twin = _cell_trainer(data)
    eager = _Eager(twin, data)
    perms = [graphed.batches(), graphed.batches()]
    idx = [p for perm in perms for p in perm]
    for i in range(6):
        graphed.step(i, idx[i])
    carry = graphed.carry()
    saved = {"modules": {k: {n: t.clone() for n, t in sd.items()}
                         for k, sd in carry["modules"].items()},
             "opt": {"count": carry["opt"]["count"],
                     **{part: {n: t.clone() for n, t in
                               carry["opt"][part].items()}
                        for part in ("mu", "nu")}}}
    gen = graphed.generator.get_state()
    profiling.reset_counters()
    for i in (6, 7):
        graphed.step(i, idx[i])
    graphed.load(saved)
    graphed.generator.set_state(gen)
    for i in range(6, 12):
        graphed.step(i, idx[i])
    torch.cuda.synchronize()
    assert _counts()["replayed_steps"] == 8
    for i in range(12):
        eager.step(i, idx[i])
    torch.cuda.synchronize()
    _assert_same(_state(graphed), _state(twin), "after the round trip")
    assert graphed.opt_state["count"] == eager.opt_state["count"] == 12


@pytest.mark.cuda
def test_graphed_bottleneck_vae_steps_are_bitwise_on_card():
    """The bottleneck VAE (strided encoder, dense and transposed convs in
    its deep decoder) at 32^2: 5 graphed steps (1 eager, 1 captured, 4
    replayed) bitwise 5 of `_Eager` on a twin trainer."""
    dev = _device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    data = tuple(torch.randn((96, 32, 32, 2), generator=g, device=dev)
                 for _ in range(3))

    def trainer():
        net = CVAEBottleneck(regression="None", nx=32, folder=MISSING,
                             deep_latent=10, device=dev)
        return VaeTrainer(net, data, 2, 32, 2e-4, key=5)
    graphed, twin = trainer(), trainer()
    eager = _Eager(twin, data)
    profiling.reset_counters()
    perm = graphed.batches()
    assert torch.equal(perm, eager.batches())
    for i in range(5):
        a = graphed.step(i, perm[i % len(perm)])
        b = eager.step(i, perm[i % len(perm)])
        _assert_same(a, b, f"metrics, step {i}")
    torch.cuda.synchronize()
    _assert_same(_state(graphed), _state(twin), "state")
    assert _counts() == {"eager_steps": 1, "captured_steps": 1,
                         "replayed_steps": 4}


HOST_READ = """
import torch
from pyqg_generative_torch.ml.train_graph import GraphedTrainStep
x = torch.ones(64, device="cuda")
step = GraphedTrainStep(lambda t: {"s": t * float(t.sum())})
step(x)
try:
    step(x)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
else:
    print("captured")
"""


@pytest.mark.cuda
def test_capture_of_a_host_read_raises_on_card():
    """A body that reads the device on the host runs eagerly the first
    time and raises at its capture (in a process of its own: a failed
    capture may leave the process's CUDA state unusable)."""
    _device("cuda")
    out = subprocess.run([sys.executable, "-c", HOST_READ], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("raised:"), out.stdout + out.stderr[-2000:]
