"""A training step captured as CUDA graphs and replayed.

A sigma-VAE batch of 64 at 64^2 is 8,318 kernels (the forward's and the
weight gradient's per-sample loops, Adam's 14 elementwise kernels a leaf),
and a GAN batch more (the critic's passes and its gradient penalty's double
backward), which the host takes longer to enqueue than the card takes to
run. `GraphedTrainStep` captures the step once per key and replays it, so a
steady batch costs the host a graph launch and a few writes; a replayed
step is bitwise the eager one. The eager, capture and replay rule, the
stream, the pool, the generators, the NaN checks, the failures, the
counters `train.*_steps` and the spans `train.eager`, `train.capture` and
`train.reset` are the core's, `utils/step_graphs.py`, with one eager step
before a capture: a key's first call runs eagerly, its second is captured.

* **The body.** `body(*inputs) -> {name: 0-dim tensor}` is the step's
  device work. It reads tensors only: its inputs, the model's parameters
  and statistics and the optimizer's state, which it updates in place, and
  static tensors that the caller writes before each call, such as Adam's
  scalars (`ml.train.Adam.scalars`); the caller advances Adam's count.
* **Keys** are the inputs' shapes and dtypes and the call's `host` values,
  the step's host decisions (the GAN's: whether the generator updates too),
  which the body takes after its inputs: `body(*inputs, *host)`. A graph
  reads its inputs from the clones the core made at its capture, into
  which each replay copies first.
* **Fresh outputs.** The graph stacks the body's outputs into one tensor,
  which each replay overwrites; the call returns views of a copy of it.
  The span `train.replay` holds a replay with its copies.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from ..utils.step_graphs import StepGraphs, counter_names

__all__ = ["GraphedTrainStep", "COUNTERS"]

COUNTERS = counter_names("train")


class GraphedTrainStep:
    """`body(*inputs, *host) -> {name: 0-dim tensor}` on CUDA inputs, eager
    the first time a key occurs, replayed from a captured graph after (see
    the module's docstring). Returns the body's outputs, fresh each call."""

    def __init__(self, body, generators=()):
        self.body = body
        self.graphs = StepGraphs("train", 1, generators)

    def __call__(self, *inputs: torch.Tensor, host: tuple = ()) -> dict:
        graphs = self.graphs
        caller = graphs.enter(inputs[0].device)
        key = (tuple(host), tuple((t.shape, t.dtype) for t in inputs))

        def stacked(*args):
            out = self.body(*args, *host)
            return list(out), torch.stack(list(out.values()))
        with torch.cuda.stream(graphs.stream):
            names, out = graphs.run(key, stacked, inputs, _replay)
        graphs.leave(caller)
        return dict(zip(names, out.unbind()))


def _replay(g, *inputs):
    names, out = g.out
    with profiling.span("train.replay"):
        for s, t in zip(g.inputs, inputs):
            s.copy_(t)
        g.graph.replay()
        return names, out.clone()
