"""The GAN's training step replayed from CUDA graphs, one a branch
(`models/cgan_regression.py::GanTrainer.step` over
`ml/train_graph.py::GraphedTrainStep`, keyed by whether the generator
updates too).

On the CPU: a `GanTrainer` steps eagerly, counts `train.eager_steps` and
`train.generator_steps` and advances each Adam's count on its own schedule;
`load` copies into the trainer's own tensors; `GraphedTrainStep` keys its
graphs by the call's host values and hands them to the body (its CUDA
calls stood in for). On the card (imports no jax): python -m pytest
tests/test_torch_gan_graph.py -m cuda --noconftest. There, at the
`gan64_train` cell's shapes (batch 64 at 64^2, published widths, fresh
weights from one seed), after a throwaway step (`_settle`), 12 graphed
steps across an epoch's end, both branches captured and replayed, are
bitwise the eager batch step on a twin trainer's modules and state, and a
carry()/load() round trip between replays stays bitwise.
"""
import contextlib

import pytest
import torch

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml.train_graph import COUNTERS, GraphedTrainStep
from pyqg_generative_torch.models import CGANRegression
from pyqg_generative_torch.models.cgan_regression import GENERATOR_STEPS, \
    GanTrainer, gan_draws, make_gan_batch_step
from pyqg_generative_torch.utils import profiling
from pyqg_generative_torch.utils.step_graphs import StepGraphs

torch.set_num_threads(1)

MISSING = "/nonexistent_model_folder"


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


def _counts() -> dict:
    c = profiling.counters()
    return {**{k: c.get(v, 0) for k, v in COUNTERS.items()},
            "generator_steps": c.get(GENERATOR_STEPS, 0)}


def _small_trainer(n=24, batch=4, key=0):
    """A GAN of 8-wide nets at 16^2 on the CPU."""
    net = CGANRegression(folder=MISSING, device="cpu", nx=16,
                         hidden_channels=(8,))
    net.D = tnets.DCGANDiscriminator(6, ndf=8, nx=16)
    g = torch.Generator().manual_seed(1)
    X, Y = (torch.randn(n, 16, 16, 2, generator=g) for _ in range(2))
    return GanTrainer(net, (X, Y, torch.zeros_like(Y)), 2, batch, 1e-3,
                      key)


def _state(trainer) -> dict:
    out = {}
    for name in ("G", "D"):
        for k, v in getattr(trainer.net, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().clone()
        for part in ("mu", "nu"):
            for k, v in trainer.opt[name][part].items():
                out[f"opt{name}.{part}.{k}"] = v.clone()
    return out


def _assert_same(a: dict, b: dict, what):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


# ------------------------------------------------------------------- CPU
def test_cpu_gan_trainer_steps_eagerly_and_counts_generator_steps():
    """7 steps (6 batches an epoch, so i = 0..5, 0): the critic's Adam
    advances every step, the generator's on i % 5 == 0 (i = 0, 5, 0), each
    counted in `train.generator_steps`; every step eager; the metrics fresh
    each step, G_loss 0 on a critic-only batch."""
    trainer = _small_trainer()
    assert trainer.graphed is None
    profiling.reset_counters()
    perm = trainer.batches()
    rows = []
    for i in list(range(6)) + [0]:
        rows.append((i, trainer.step(i, perm[i])))
    assert _counts() == {"eager_steps": 7, "captured_steps": 0,
                         "replayed_steps": 0, "generator_steps": 3}
    assert trainer.opt["D"]["count"] == 7 and trainer.opt["G"]["count"] == 3
    for i, m in rows:
        assert list(m) == ["D_loss", "D_grad", "D_drift", "G_loss"]
        assert (float(m["G_loss"]) != 0) == (i % 5 == 0), i
    assert rows[0][1]["D_loss"].data_ptr() != rows[1][1]["D_loss"].data_ptr()


def test_gan_load_copies_into_the_trainers_tensors():
    """`load` puts a saved carry back into the modules' and both Adams'
    own tensors (the ones a captured graph holds), with the counts."""
    trainer = _small_trainer()
    perm = trainer.batches()
    trainer.step(0, perm[0])
    carry = trainer.carry()
    saved = {k: {n: (t.clone() if isinstance(t, torch.Tensor) else t)
                 for n, t in v.items()} for k, v in carry.items()
             if k in ("G", "D")}
    for k in ("optG", "optD"):
        saved[k] = {"count": carry[k]["count"],
                    **{part: {n: t.clone() for n, t in carry[k][part].items()}
                       for part in ("mu", "nu")}}
    params = {(net, n): p for net in ("G", "D") for n, p in
              getattr(trainer.net, net).named_parameters()}
    moments = {net: dict(trainer.opt[net]["mu"]) for net in ("G", "D")}
    opt = trainer.opt
    for i in (1, 2, 3, 4, 5):
        trainer.step(i, perm[i])
    trainer.load(saved)
    assert trainer.opt is opt
    assert opt["D"]["count"] == 1 and opt["G"]["count"] == 1
    for net in ("G", "D"):
        for n, p in getattr(trainer.net, net).named_parameters():
            assert p is params[net, n]
            assert torch.equal(p, saved[net][n])
        for n, t in opt[net]["mu"].items():
            assert t is moments[net][n]
            assert torch.equal(t, saved[f"opt{net}"]["mu"][n])


class _Graph:
    """Stands in for torch.cuda.CUDAGraph."""

    def __init__(self, keep_graph=False):
        self.replays = 0

    def register_generator_state(self, generator):
        pass

    def replay(self):
        self.replays += 1


def test_graphed_train_step_keys_on_host_values(monkeypatch):
    """A call's `host` values are part of its key beside the inputs'
    shapes and reach the body after the inputs: a GAN period (generator,
    then 4 critic-only batches, then the generator) makes one graph a
    branch, each eager once, captured at its second call and replayed
    after; a replay copies the call's inputs into the graph's."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s:
                        contextlib.nullcontext())
    monkeypatch.setattr(StepGraphs, "enter", lambda self, device: None)
    monkeypatch.setattr(StepGraphs, "leave", lambda self, caller: None)
    calls = []

    def body(x, gen_step):
        calls.append(gen_step)
        return {"s": x.sum() + 10.0 * gen_step}

    step = GraphedTrainStep(body)
    profiling.reset_counters()
    outs = [step(torch.full((3,), float(i)), host=(i % 5 == 0,))["s"]
            for i in range(11)]
    # the stand-in's replay leaves the capture's output as it was
    assert [float(s) for s in outs] == [10, 3, 6, 6, 6, 25, 6, 6, 6, 6, 25]
    keys = sorted(step.graphs.graphs)
    assert keys == [((False,), ((torch.Size([3]), torch.float32),)),
                    ((True,), ((torch.Size([3]), torch.float32),))]
    # eager: i = 0 (generator), 1 (critic); captured: 2 (critic), 5
    # (generator); the rest replayed
    assert calls == [True, False, False, True]
    assert _counts() == {"eager_steps": 2, "captured_steps": 2,
                         "replayed_steps": 9, "generator_steps": 0}
    g = step.graphs.graphs[((False,), ((torch.Size([3]), torch.float32),))]
    assert torch.equal(g.inputs[0], torch.full((3,), 9.0))
    assert sum(c.graph.replays for c in step.graphs.graphs.values()) == 9


# ------------------------------------------------------------------ card
def _cell_data(dev, n):
    """n standard normal samples of the cell's (x, y) at 64^2, ymean 0."""
    g = torch.Generator(device=dev).manual_seed(7)
    data = tuple(torch.randn((n, 64, 64, 2), generator=g, device=dev)
                 for _ in range(2))
    return data + (torch.zeros_like(data[1]),)


def _cell_trainer(data, key=2147500111):
    """The cell's GAN (published widths, the critic 64 to 512 wide, 64^2)
    from fresh weights drawn from `key`, on `data`."""
    net = CGANRegression(folder=MISSING, device=data[0].device)
    return GanTrainer(net, data, 200, 64, 2e-4, key=key)


def _settle(data):
    """A throwaway trainer's critic-only step, eager. The first critic step
    of a process differs from every later one in the last bits of the
    critic's weight gradients (Conv_0 to Conv_2), graphed or not, on any
    stream, with or without cuDNN's input gradients; a second step and
    every later one agree bitwise (an H100, `gan64_train`'s shapes). The
    comparisons below start after it, so that they see the graphs alone."""
    w = _cell_trainer(data)
    w.graphed = None
    w.step(1, w.batches()[0])
    torch.cuda.synchronize()


class _Eager:
    """The GAN's batch step run eagerly on a twin trainer's modules, Adam
    states, generator and data, apart from `GanTrainer.step`: the rows'
    gather, `gan_draws` and `make_gan_batch_step` without scalars, whose
    Adams write their own and advance their own counts."""

    def __init__(self, trainer, data):
        self.trainer, self.data = trainer, data
        self.step_fn = make_gan_batch_step(trainer.net, trainer.txG,
                                           trainer.txD)

    def step(self, i, idx):
        t = self.trainer
        batch = tuple(d[idx] for d in self.data)
        draws = gan_draws(t.generator, batch[0], t.net.n_latent)
        return self.step_fn(t.opt, batch, i % 5 == 0, draws)


@pytest.mark.cuda
def test_graphed_gan_steps_are_bitwise_the_eager_ones_on_card():
    """12 steps (6 batches an epoch: i = 0..5, 0..5, so 4 generator
    batches and both branches captured) of the graphed trainer and of
    `_Eager` on a twin trainer, from the same weights and rows: every
    metric, parameter, BatchNorm statistic, Adam moment and count bitwise
    at every step; 2 eager, 2 captured and 10 replayed steps (the captures'
    replays counted); each step's metrics unchanged by the next step."""
    dev = _device("cuda")
    data = _cell_data(dev, 5 * 64 + 10)
    _settle(data)
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
            rows.append((m, dict(D=graphed.opt["D"]["count"],
                                 G=graphed.opt["G"]["count"]),
                         _state(graphed)))
    assert len(rows) == 12
    assert _counts() == {"eager_steps": 2, "captured_steps": 2,
                         "replayed_steps": 10, "generator_steps": 4}
    n = 0
    for perm in perms:
        assert torch.equal(twin.batches(), perm)
        for j in range(len(perm)):
            m = eager.step(j, perm[j])
            torch.cuda.synchronize()
            want_m, want_counts, want_state = rows[n]
            _assert_same(m, want_m, f"metrics, step {n}")
            assert {k: twin.opt[k]["count"] for k in "DG"} == want_counts
            _assert_same(_state(twin), want_state, f"state, step {n}")
            n += 1
    assert twin.opt["D"]["count"] == 12 and twin.opt["G"]["count"] == 4


@pytest.mark.cuda
def test_gan_carry_and_load_between_replays_stay_bitwise_on_card():
    """A graphed trainer saves its carry and generator after 7 steps (both
    branches replayed by then), runs 3 more, loads them back and runs the
    last 5 again (replays on the copied-in tensors): bitwise 12 steps of
    `_Eager` on a twin trainer."""
    dev = _device("cuda")
    data = _cell_data(dev, 6 * 64)
    _settle(data)
    graphed = _cell_trainer(data)
    twin = _cell_trainer(data)
    eager = _Eager(twin, data)
    perms = [graphed.batches(), graphed.batches()]
    rows = [(i, p) for perm in perms for i, p in enumerate(perm)]
    for i, idx in rows[:7]:
        graphed.step(i, idx)
    carry = graphed.carry()
    saved = {k: {n: t.clone() for n, t in carry[k].items()}
             for k in ("G", "D")}
    for k in ("optG", "optD"):
        saved[k] = {"count": carry[k]["count"],
                    **{part: {n: t.clone() for n, t in carry[k][part].items()}
                       for part in ("mu", "nu")}}
    gen = graphed.generator.get_state()
    profiling.reset_counters()
    for i, idx in rows[7:10]:
        graphed.step(i, idx)
    graphed.load(saved)
    graphed.generator.set_state(gen)
    for i, idx in rows[7:]:
        graphed.step(i, idx)
    torch.cuda.synchronize()
    assert _counts()["replayed_steps"] == 8
    assert _counts()["eager_steps"] == 0
    for i, idx in rows:
        eager.step(i, idx)
    torch.cuda.synchronize()
    _assert_same(_state(graphed), _state(twin), "after the round trip")
    assert {k: graphed.opt[k]["count"] for k in "DG"} == \
        {k: twin.opt[k]["count"] for k in "DG"} == {"D": 12, "G": 4}
