"""The port's spans and named counters (`utils/profiling.py`) and the
benchmark's readers of them, on the CPU: the spans of a `run_ensemble` job
and of a VAE training step, their parents and shared root; the bounded
buffer; the profiler mirror, which runs only while a profiler records and
then lies inside its record; the counters behind the old module names; and
each per-layer reader of the spans on a hand-built trace. One test runs on
the card: python -m pytest tests/test_torch_tracing.py -m cuda --noconftest
"""
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from pyqg_generative_torch.ml import fused_conv
from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.models import CVAERegression
from pyqg_generative_torch.models.cvae_regression import VaeTrainer
from pyqg_generative_torch.qg import core, diagnostics
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.sim import graph, run_ensemble
from pyqg_generative_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import manifest, tracing, yardstick  # noqa: E402

torch.set_num_threads(1)

DT = 14400.0
JOB = ("sim.initial_conditions", "sim.init_carry", "sim.advance",
       "sim.to_host", "sim.to_host", "sim.dataset")


def _job(steps=4, snaps=2, device="cpu", key=3):
    p = QGParams(nx=16, dt=DT, tmax=steps * DT, tavestart=0.0)
    profiling.clear_spans()
    run_ensemble(p, None, n_ens=2, sampling_freq=steps // snaps * DT,
                 key=key, device=device)
    return p, profiling.spans()


def test_run_ensemble_spans_parents_and_root():
    _, recs = _job()
    root, = [r for r in recs if r.parent_id is None]
    assert root.name == "sim.run_ensemble"
    assert root.attrs == {"members": 2, "steps": 4, "key": 3}
    assert all(r.root_id == root.span_id for r in recs)
    by_id = {r.span_id: r for r in recs}
    parent = {r.name: by_id[r.parent_id].name for r in recs if r.parent_id}
    assert sorted(n for n, p in parent.items() if p == root.name) == \
        sorted(set(JOB))
    assert parent["sim.snapshot"] == parent["sim.finalize"] == "sim.advance"
    assert [r.name for r in recs].count("sim.snapshot") == 2
    for r in recs:  # each inside its parent, on one clock
        if r.parent_id:
            up = by_id[r.parent_id]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns


def test_spans_follow_snapshots_not_steps():
    """No span opens once a step: a job of 4 steps and one of 12, each in
    2 snapshots, keep the same spans."""
    names = [[r.name for r in _job(steps)[1]] for steps in (4, 12)]
    assert names[0] == names[1]


def test_span_buffer_is_bounded():
    profiling.clear_spans()
    extra = 5
    for i in range(profiling.SPAN_BUFFER + extra):
        with profiling.span("bounded", i=i):
            pass
    recs = profiling.spans()
    assert len(recs) == profiling.SPAN_BUFFER
    assert recs[0].attrs["i"] == extra and recs[-1].attrs["i"] == \
        profiling.SPAN_BUFFER + extra - 1
    profiling.clear_spans()
    assert profiling.spans() == []


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, recs = _job()
    assert len(recs) == len(JOB) + 4


@pytest.fixture(scope="module")
def profiler_ready():
    """The profiler started once and a span mirrored once: the process's
    first start imports much of torch (seconds), and its first mirror
    loads the profiler's operators."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with profiling.span("warm-up"):
            pass
    return acts


def test_mirror_lies_inside_its_record(profiler_ready):
    """Under torch.profiler each span is also a profiler event, and its
    in-memory record holds that event within 100 us at either end: both
    are stamped on one clock. The session's first mirror sets up the
    profiler's state for the thread (tens of us), so a span opens first."""
    with torch.profiler.profile(activities=profiler_ready) as prof:
        with profiling.span("first"):
            pass
        profiling.clear_spans()
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).sum()
            with profiling.span("inner"):
                torch.ones(64).sum()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        events.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    recs = profiling.spans()
    assert [r.name for r in recs] == ["inner", "inner", "outer"]
    for name in ("inner", "outer"):
        mine = [r for r in recs if r.name == name]
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        for r, (s, e) in zip(mine, theirs):
            assert r.start_ns <= s <= r.start_ns + 100_000
            assert e <= r.end_ns <= e + 100_000


def test_counters_and_the_old_names():
    profiling.count("test.things", 2)
    profiling.count("test.things")
    assert profiling.counters()["test.things"] == 3
    profiling.count("graph.replayed_steps", 5)
    profiling.count("fused_conv.launches_packed", 2)
    c = profiling.counters()
    for name, full in {**graph.COUNTERS, **fused_conv.COUNTERS}.items():
        module = graph if full.startswith("graph.") else fused_conv
        assert getattr(module, name) == c[full]
    assert graph.replayed_steps >= 5 and fused_conv.launches_packed >= 2
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0}
    assert graph.replayed_steps == fused_conv.launches_packed == 0
    with pytest.raises(AttributeError):
        graph.no_such_counter


def test_online_driver_counts_read_the_registry():
    from benchmark.drivers.online_ensemble import Driver
    profiling.count("graph.eager_steps", 4)
    profiling.count("fused_conv.launches", 7)
    c = profiling.counters()
    assert Driver._counts(None) == {
        "eager_steps": c["graph.eager_steps"],
        "captured_steps": c["graph.captured_steps"],
        "replayed_steps": c["graph.replayed_steps"],
        "k1_calls": c["fused_conv.launches"],
        "k1_bf16_calls": c["fused_conv.launches_bf16"],
        "k2_calls": c["fused_conv.launches_packed"]}


def test_vae_trainer_step_spans():
    net = CVAERegression(folder="/nonexistent_model_folder", device="cpu",
                         hidden_channels=(8,))
    net.encoder = tnets.AndrewCNN(4, 4, hidden_channels=(8,))
    g = torch.Generator().manual_seed(0)
    X, Y = (torch.randn(8, 16, 16, 2, generator=g) for _ in range(2))
    trainer = VaeTrainer(net, (X, Y, torch.zeros_like(Y)), 1, 4, 1e-3, 0)
    profiling.clear_spans()
    trainer.step(0, trainer.batches()[0])
    recs = profiling.spans()
    root = recs[-1]
    assert root.name == "train.step" and root.parent_id is None
    assert [(r.name, r.parent_id, r.root_id) for r in recs[:-1]] == [
        (n, root.span_id, root.span_id) for n in
        ("train.batch", "train.forward", "train.backward",
         "train.optimizer")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:-1]))


def test_timer_waits_for_the_card(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    assert profiling.timer(lambda: calls.append("call") or 1)() == 1
    assert calls == ["call", "sync"]
    assert "executed in" in capsys.readouterr().out


# ----------------------------------------------------------------- readers
def _trace(host, device, window=(0.0, 1000.0)):
    return tracing.Trace(device=[("k", s, e) for s, e in device],
                         host=[(tracing.MARK,) + window] + host,
                         window=window)


def _ctx(trace, **work):
    return SimpleNamespace(trace=trace, work=work, counters={},
                           config={}, traffic={}, yardstick=yardstick)


# a job's host spans (us) and its kernels: idle gaps 0-10 (no program
# span), 40-60 (graph.eager), 150-160 (sim.advance), 300-310 (sim.snapshot),
# 880-900 (sim.to_host) and 950-1000 (sim.dataset)
JOB_HOST = [("benchmark.run_ensemble", 5, 995),
            ("sim.run_ensemble", 8, 990), ("sim.advance", 30, 870),
            ("graph.eager", 35, 65), ("graph.capture", 70, 100),
            ("sim.snapshot", 295, 315), ("sim.to_host", 875, 905),
            ("sim.dataset", 940, 990), ("cudaLaunchKernel", 36, 37)]
JOB_DEVICE = [(10, 40), (60, 150), (160, 300), (310, 880), (900, 950)]


def _stall_records(window):
    lo, hi = (w * 1000 for w in window)

    def job(start_ms, ms, steps=20):
        s = int(lo + start_ms * 1e6)
        return profiling.Span("sim.run_ensemble", s, s + int(ms * 1e6), 1,
                              None, 1, {"steps": steps})
    # the set-up's short job, the traced job (overlaps the window) and
    # four untraced full-length jobs, one stalled
    return [job(-100, 50, steps=4), job(0, 1), job(10, 100),
            job(120, 100), job(240, 100), job(360, 500)]


CASES = {
    "online.edge_idle_ms": (
        lambda mp: _ctx(_trace(JOB_HOST, JOB_DEVICE), steps=20),
        (10 + 20 + 20 + 50) / 1e3),
    "online.warmup_ms_per_job": (
        lambda mp: _ctx(_trace(JOB_HOST, JOB_DEVICE), steps=20),
        (30 + 30) / 1e3),
    "online.stall_ms_per_job": (
        lambda mp: (mp.setattr(profiling, "spans",
                               lambda: _stall_records((0.0, 1000.0))),
                    _ctx(_trace(JOB_HOST, JOB_DEVICE), steps=20))[1],
        statistics.fmean([100, 100, 100, 500]) - 100.0),
    "train.optimizer_launches_per_batch": (
        lambda mp: _ctx(_trace(
            [("train.step", 0, 400), ("train.optimizer", 300, 400),
             ("train.step", 500, 900), ("train.optimizer", 800, 900)]
            + [("cudaLaunchKernel", t, t + 1) for t in (100, 310, 320,
                                                        810, 820, 830)]
            + [("cuLaunchKernel", 350, 351), ("cudaMemcpyAsync", 360, 361)],
            [(0, 1000)]), batches=2),
        (3 + 3) / 2),
}


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_on_a_hand_built_trace(metric, monkeypatch):
    make, want = CASES[metric]
    assert manifest.reader(metric)(make(monkeypatch)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_without_the_spans_reads_nothing(metric, monkeypatch):
    """A program without the port's spans (only the harness's own span and
    runtime calls in the trace, no `spans()` in its profiling module) reads
    None."""
    monkeypatch.delattr(profiling, "spans")
    host = [h for h in JOB_HOST if not h[0].startswith(("sim.", "graph."))]
    ctx = _ctx(_trace(host, JOB_DEVICE), steps=20, batches=2)
    assert manifest.reader(metric)(ctx) is None


# -------------------------------------------------------------------- card
@pytest.mark.cuda
def test_graph_spans_on_the_card_share_the_device_clock():
    """A graphed 16^2 job under the benchmark's profiler: `graph.eager` and
    `graph.capture` appear as often as `WARMUP_STEPS` and the job's host
    branches say, and the device's kernels fall after their launching
    span's start on the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    steps = 24
    p = QGParams(nx=16, dt=DT, tmax=steps * DT, tavestart=10 * DT)
    run_ensemble(p, None, n_ens=2, sampling_freq=6 * DT, device="cuda")
    out = []
    with tracing.traced(out):
        run_ensemble(p, None, n_ens=2, sampling_freq=6 * DT, device="cuda")
    t = out[-1]
    # the branches: AB3's start and the diagnostics' gate (no closure)
    seen, graphs, eager, captures = set(), set(), 0, 0
    for tc in range(steps):
        key = (core.ab3_coefficients(tc),
               diagnostics.diag_gate(SimpleNamespace(tc=tc), p), False)
        if key in graphs:
            continue
        if key in seen and eager >= graph.WARMUP_STEPS:
            graphs.add(key)
            captures += 1
        else:
            seen.add(key)
            eager += 1
    names = [h[0] for h in t.host]
    assert (names.count("graph.eager"), names.count("graph.capture")) == \
        (eager, captures) and captures >= 2
    first = min((h for h in t.host if h[0] == "graph.eager"),
                key=lambda h: h[1])
    kernels = sorted(s for name, s, _ in t.device if not
                     name.lower().startswith(("memcpy", "memset")))
    launches = [s for name, s, _ in t.host
                if name.startswith(("cudaLaunch", "cuLaunch"))]
    assert kernels, "the profiler saw no kernel"
    # no kernel starts before its launch, and the first kernel after the
    # span's start starts inside the span
    before = sum(s < first[1] for s in kernels)
    assert before <= sum(s < first[1] for s in launches)
    after = [s for s in kernels if s >= first[1]]
    assert after and after[0] <= first[2]
