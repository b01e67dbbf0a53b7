"""One online step captured as a CUDA graph and replayed.

The port's counterpart of the twin's `lax.scan` body (`_advance_program`,
`pyqg_generative_tpu/sim/simulate.py:127-144`): there the whole simulation is
one XLA program and the host never enqueues a step; here a step is 98-107
kernels, which the host takes longer to enqueue than the card takes to run.
`GraphedStep` captures the eager step (`make_online_step`) once per host
branch and replays it, so a steady-state step costs the host one graph
launch.

* **Static carry.** The carry's tensors (`qh`, `dqhdt_p`, `dqhdt_pp`, the
  sampler's `noise` and `forcing`, the accumulator's `sums`) live in buffers
  allocated once. Every step, eager or replayed, ends by copying its outputs
  into them, `dqhdt_pp <- dqhdt_p` before `dqhdt_p <- dqhdt`, since
  `ab3_update` hands the old `dqhdt_p` on as the new `dqhdt_pp`. The
  carries it returns hold these buffers, so a returned carry is overwritten
  by the next step of the same `GraphedStep`.
* **Host branches.** The AB3 start (`core.ab3_coefficients`), the
  diagnostics gate (`diagnostics.diag_gate`) and the constant sampler's draw
  (`stochastic.redraws`) are host decisions; each combination that occurs
  gets a graph of its own. A combination is captured the second time it
  occurs and only after `WARMUP_STEPS` eager steps, so the first steps run
  eagerly on the capture stream: they build cuFFT's plans, pick cuDNN's
  algorithm for Conv_0, build and bind the kernels' libraries, resolve the
  closure's variant (K3 reads its words back to the host) and allocate K2's
  counter buffer for that stream, none of which may happen under capture.
  Tc 0 and 1 (Euler, AB2) occur once each and so always run eagerly.
* **Host counters** (`t`, `tc`, `SamplerState.counter`,
  `DiagAccumulator.count`) advance on the host after a replay by what the
  captured step advanced them by.
* **Random draws.** The sampler's generator is registered with every graph,
  so a replay draws fresh noise and moves the generator on as an eager draw
  does.
* **Weights switch.** A model that loads other weights
  (`use_optimal_epoch`, `use_stable_epoch`, `load_model`) raises its
  `weights_generation`; a graph holds the addresses of the weights derived
  at its capture, so on a new generation the step drops its graphs and warms
  up and captures again, and never replays a graph of the old weights.
* **NaN checks.** While `utils.debugging.debug_nans` is open, whose
  checks read the device, the step neither captures nor replays: it runs
  eagerly.
* **Spans** (`utils.profiling.span`): `graph.eager` around each eager step,
  `graph.capture` around each capture (the graph pool's creation and
  `instantiate` included), `graph.reset` where a new weights generation
  drops the graphs. A replay only counts.
* **Failure raises.** A capture that meets a host read of the device, an
  allocation of K2's counters or any other call that stream capture refuses
  raises; so does a replay that fails, and a capture that records K2 as a
  kernel that is not cooperative. There is no fallback to the eager loop.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ml import fused_conv
from ..qg import core, diagnostics
from ..qg.params import QGParams
from ..utils import debugging, profiling
from . import simulate
from .stochastic import redraws

__all__ = ["GraphedStep", "WARMUP_STEPS"]

WARMUP_STEPS = 3

# Steps run by every GraphedStep of the process, as counters of
# `utils.profiling`: eagerly, captured (each of which is replayed at once)
# and replayed. A wrapper's launch count grows by eager and captured steps
# only; a replay calls no wrapper. `graph.eager_steps` and the others read
# the counters.
COUNTERS = {k: f"graph.{k}" for k in ("eager_steps", "captured_steps",
                                      "replayed_steps")}
for _name in COUNTERS.values():
    profiling.count(_name, 0)


def __getattr__(name):
    if name in COUNTERS:
        return profiling.counters().get(COUNTERS[name], 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    counter_step: int       # SamplerState.counter advance
    count_step: float       # DiagAccumulator.count advance


def _tensors(carry) -> list:
    """The carry's tensors in the order they are stored after a step:
    dqhdt_pp first, which takes the old dqhdt_p."""
    state, sstate, acc = carry
    out = [state.dqhdt_pp, state.dqhdt_p, state.qh]
    if sstate is not None:
        out += [sstate.noise, sstate.forcing]
    if acc is not None:
        out += [acc.sums[k] for k in sorted(acc.sums)]
    return out


class GraphedStep:
    """The online step of `make_online_step(p, model, sampling, nsteps,
    with_diags)` on a CUDA carry, replayed from captured graphs (see the
    module's docstring). Call it as the eager step: carry -> carry. The
    carries it returns share its buffers; a carry it did not return is
    copied in first."""

    def __init__(self, p: QGParams, model=None, sampling: str = "AR1",
                 nsteps: int = 1, with_diags: bool = True):
        self.p, self.sampling, self.nsteps = p, sampling, nsteps
        self.model = model
        self._step = simulate.make_online_step(p, model, sampling, nsteps,
                                              with_diags)
        self._generation = self._weights_generation()
        self._graphs: dict = {}
        self._seen: set = set()
        self._eager = 0
        self._buffers = None    # the carry's tensors, in `_tensors` order
        self._generator = None
        self._pool = None
        self.stream = None

    def __call__(self, carry):
        device = carry[0].qh.device
        if device.type != "cuda":
            raise ValueError(f"a graphed step needs a CUDA carry, not "
                             f"{device}")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        if self._weights_generation() != self._generation:
            with profiling.span("graph.reset"):
                self._graphs.clear()
                self._seen.clear()
                self._eager = 0
                self._generation = self._weights_generation()
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            carry = self._load(carry)
            key = self._branch(carry)
            checking = debugging.checks_active()
            if key in self._graphs and not checking:
                out = self._replay(key, carry)
            elif key in self._seen and self._eager >= WARMUP_STEPS \
                    and not checking:
                self._capture(key, carry)
                out = self._replay(key, carry)
            else:
                out = self._run_eagerly(key, carry)
        caller.wait_stream(self.stream)
        return out

    def _weights_generation(self) -> int:
        return getattr(self.model, "weights_generation", 0)

    def _branch(self, carry):
        """The host decisions of this step, which select its graph."""
        state, sstate, acc = carry
        return (core.ab3_coefficients(state.tc),
                acc is not None and diagnostics.diag_gate(state, self.p),
                sstate is not None
                and redraws(sstate, self.sampling, self.nsteps))

    def _load(self, carry):
        """The carry on the static buffers: allocated from the first carry,
        copied into from any carry this step did not return."""
        given = _tensors(carry)
        generator = None if carry[1] is None else carry[1].generator
        if self._buffers is None:
            self._buffers = [t.clone() for t in given]
            self._generator = generator
        elif all(b is t for b, t in zip(self._buffers, given)):
            return carry
        else:
            if generator is not self._generator:
                raise ValueError("a graphed step keeps the generator of its "
                                 "first carry")
            if [(t.shape, t.dtype) for t in given] != \
                    [(b.shape, b.dtype) for b in self._buffers]:
                raise ValueError("the carry's tensors differ in number, "
                                 "shape or dtype from the step's")
            for b, t in zip(self._buffers, given):
                b.copy_(t)
        return self._with_tensors(carry, self._buffers)

    @staticmethod
    def _with_tensors(carry, tensors):
        state, sstate, acc = carry
        it = iter(tensors)
        pp, dp, qh = next(it), next(it), next(it)
        state = dataclasses.replace(state, qh=qh, dqhdt_p=dp, dqhdt_pp=pp)
        if sstate is not None:
            noise, forcing = next(it), next(it)
            sstate = dataclasses.replace(sstate, noise=noise,
                                         forcing=forcing)
        if acc is not None:
            acc = dataclasses.replace(acc, sums={
                k: next(it) for k in sorted(acc.sums)})
        return state, sstate, acc

    def _store(self, out):
        """Copy a step's outputs into the static buffers, in `_tensors`'
        order; an output that is already its buffer stays."""
        for b, t in zip(self._buffers, _tensors(out)):
            if t.data_ptr() != b.data_ptr():
                b.copy_(t)

    def _run_eagerly(self, key, carry):
        with profiling.span("graph.eager"):
            out = self._step(carry)
            self._store(out)
        self._seen.add(key)
        self._eager += 1
        profiling.count("graph.eager_steps")
        return self._with_tensors(out, self._buffers)

    def _capture(self, key, carry):
        with profiling.span("graph.capture"):
            self._capture_graph(key, carry)
        profiling.count("graph.captured_steps")

    def _capture_graph(self, key, carry):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if carry[1] is not None:
            graph.register_generator_state(carry[1].generator)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        k2 = "fused_conv.launches_packed"
        before = profiling.counters().get(k2, 0)
        with torch.cuda.graph(graph, pool=self._pool, stream=self.stream):
            out = self._step(carry)
            self._store(out)
        k2_calls = profiling.counters()[k2] - before
        if k2_calls:
            # K2's grid.sync() needs a co-resident grid: its graph node must
            # keep the cooperative launch
            kernels, cooperative = fused_conv.graph_kernel_nodes(
                graph.raw_cuda_graph())
            if cooperative != k2_calls:
                raise RuntimeError(
                    f"stream capture recorded {cooperative} cooperative "
                    f"kernel nodes of {kernels} for {k2_calls} K2 launches")
        graph.instantiate()
        state, sstate, acc = carry
        self._graphs[key] = _Graph(
            graph,
            0 if sstate is None else out[1].counter - sstate.counter,
            0.0 if acc is None else out[2].count - acc.count)

    def _replay(self, key, carry):
        g = self._graphs[key]
        g.graph.replay()
        profiling.count("graph.replayed_steps")
        state, sstate, acc = carry
        state = dataclasses.replace(state, t=state.t + self.p.dt,
                                    tc=state.tc + 1)
        if sstate is not None:
            sstate = dataclasses.replace(
                sstate, counter=sstate.counter + g.counter_step)
        if acc is not None:
            acc = dataclasses.replace(acc, count=acc.count + g.count_step)
        return state, sstate, acc
