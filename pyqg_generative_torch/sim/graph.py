"""One online step captured as a CUDA graph and replayed.

The port's counterpart of the twin's `lax.scan` body (`_advance_program`,
`pyqg_generative_tpu/sim/simulate.py:127-144`). A step is 98-107 kernels,
which the host takes longer to enqueue than the card takes to run;
`GraphedStep` captures the eager step (`make_online_step`) once per host
branch and replays it, so a steady step costs the host one graph launch.
The eager, capture and replay rule (`WARMUP_STEPS` eager steps before a
capture), the stream, the pool, the generators, the NaN checks, the
failures, the counters `graph.*_steps` and the spans `graph.eager`,
`graph.capture` and `graph.reset` are the core's, `utils/step_graphs.py`.

* **Static carry.** The carry's tensors (`qh`, `dqhdt_p`, `dqhdt_pp`, the
  sampler's `noise` and `forcing`, the accumulator's `sums`) live in buffers
  allocated once. Every step ends by copying its outputs into them,
  `dqhdt_pp <- dqhdt_p` before `dqhdt_p <- dqhdt`, since `ab3_update` hands
  the old `dqhdt_p` on as the new `dqhdt_pp`. A returned carry holds these
  buffers, so the next step of the same `GraphedStep` overwrites it.
* **Host branches**, the key: the AB3 start (`core.ab3_coefficients`), the
  diagnostics gate (`diagnostics.diag_gate`) and the constant sampler's draw
  (`stochastic.redraws`). Tc 0 and 1 (Euler, AB2) occur once each and so
  always run eagerly. The eager steps also resolve the closure's variant
  (K3 reads its words back) and allocate K2's counters for the stream.
* **Host counters** (`t`, `tc`, `SamplerState.counter`,
  `DiagAccumulator.count`) advance on the host after a replay by what the
  captured step advanced them by; the sampler's generator is the core's.
* **Weights switch.** A model that loads other weights (`use_optimal_epoch`,
  `use_stable_epoch`, `load_model`) raises its `weights_generation`; a
  graph holds the addresses of the weights derived at its capture, so a
  new generation resets the core. A capture that records K2 as a kernel
  that is not cooperative raises.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ml import fused_conv
from ..qg import core, diagnostics
from ..qg.params import QGParams
from ..utils import profiling
from ..utils.step_graphs import StepGraphs, counter_names
from . import simulate
from .stochastic import redraws

__all__ = ["GraphedStep", "WARMUP_STEPS"]

WARMUP_STEPS = 3

# Steps run by every GraphedStep of the process; a wrapper's launch count
# grows by eager and captured steps only. `graph.eager_steps` reads one.
COUNTERS = counter_names("graph")
K2 = fused_conv.COUNTERS["launches_packed"]


def __getattr__(name):
    if name in COUNTERS:
        return profiling.counters().get(COUNTERS[name], 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
        self.graphs = StepGraphs("graph", WARMUP_STEPS, on_capture=_check_k2)
        self._buffers = None    # the carry's tensors, in `_tensors` order
        self._generator = None

    @property
    def stream(self):
        return self.graphs.stream

    def __call__(self, carry):
        graphs = self.graphs
        caller = graphs.enter(carry[0].qh.device)
        if self._weights_generation() != self._generation:
            graphs.reset()
            self._generation = self._weights_generation()
        with torch.cuda.stream(graphs.stream):
            carry = self._load(carry)
            out = graphs.run(self._branch(carry), self._stored, (carry,),
                             self._replay)
        graphs.leave(caller)
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
            if generator is not None:
                self.graphs.generators = (generator,)
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

    def _stored(self, carry):
        """The step, its outputs copied into the static buffers in
        `_tensors`' order (an output that is already its buffer stays): the
        carry on the buffers."""
        out = self._step(carry)
        for b, t in zip(self._buffers, _tensors(out)):
            if t.data_ptr() != b.data_ptr():
                b.copy_(t)
        return self._with_tensors(out, self._buffers)

    def _replay(self, g, carry):
        """Launch the graph; the host counters advance as at its capture."""
        g.graph.replay()
        (_, s0, a0), (_, s1, a1) = g.inputs[0], g.out
        state, sstate, acc = carry
        state = dataclasses.replace(state, t=state.t + self.p.dt,
                                    tc=state.tc + 1)
        if sstate is not None:
            sstate = dataclasses.replace(
                sstate, counter=sstate.counter + (s1.counter - s0.counter))
        if acc is not None:
            acc = dataclasses.replace(acc,
                                      count=acc.count + (a1.count - a0.count))
        return state, sstate, acc


def _check_k2(g, before):
    """K2's grid.sync() needs a co-resident grid: each of its graph nodes
    must keep the cooperative launch."""
    k2_calls = profiling.counters().get(K2, 0) - before.get(K2, 0)
    if k2_calls:
        kernels, cooperative = fused_conv.graph_kernel_nodes(
            g.graph.raw_cuda_graph())
        if cooperative != k2_calls:
            raise RuntimeError(
                f"stream capture recorded {cooperative} cooperative "
                f"kernel nodes of {kernels} for {k2_calls} K2 launches")
