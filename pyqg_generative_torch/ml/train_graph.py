"""A training step captured as a CUDA graph and replayed.

A sigma-VAE batch of 64 at 64^2 is 8,318 kernels (the forward's and the
weight gradient's per-sample loops, Adam's 14 elementwise kernels a leaf),
which the host takes longer to enqueue than the card takes to run them.
`GraphedTrainStep` captures the step once per key and replays it, so a
steady batch costs the host a graph launch and a few writes. The kernels
are the eager step's, in its order, with its arguments: a replayed step is
bitwise the eager one. It is the training counterpart of
`sim/graph.py::GraphedStep`, which does the same for an online step.

* **The body.** `body(*inputs) -> {name: 0-dim tensor}` is the step's
  device work. It reads tensors only: its inputs, the model's parameters
  and statistics and the optimizer's state, which it updates in place, and
  static tensors that the caller writes before each call, such as Adam's
  scalars (`ml.train.Adam.scalars`). What changes on the host from step to
  step (Adam's count) the caller advances after each call.
* **Keys.** A call's key is its inputs' shapes and dtypes. The first call
  of a key runs the body eagerly on the step's own stream: it loads and
  picks what a capture may not (cuDNN from the forward's thread, the cuBLAS
  and cuDNN handles and workspaces of that stream, the algorithms). The
  second call of the key captures the body into a graph of its own and
  replays it at once; every later call replays it.
* **Static inputs.** A graph reads its inputs from buffers allocated at its
  capture; each replay first copies the call's inputs into them.
* **Random draws.** Each generator the body draws from is registered with
  every graph, so a replay draws what an eager step would and moves the
  generator on as it would.
* **Fresh outputs.** The graph stacks the body's outputs into one tensor,
  which each replay overwrites; the call returns views of a copy of it, so
  that a step's outputs stay as they were after the next step.
* **Memory.** Each step owns its graphs' memory pool; the pool holds one
  step's intermediates for the step's life.
* **NaN checks.** While `utils.debugging.debug_nans` is open, whose checks
  read the device, the step neither captures nor replays: it runs eagerly.
* **Failure raises.** A capture that meets a host read of the device or any
  other call that stream capture refuses raises; there is no fallback to
  the eager step.
* **Counters and span** (`utils.profiling`): `train.eager_steps`,
  `train.captured_steps` (each replayed at once) and
  `train.replayed_steps`, the capture's replay counted as captured, not
  as replayed; the span `train.replay` around each replay, the copies of
  its inputs and outputs included.
"""
from __future__ import annotations

import torch

from ..utils import debugging, profiling

__all__ = ["GraphedTrainStep", "COUNTERS"]

COUNTERS = {k: f"train.{k}" for k in ("eager_steps", "captured_steps",
                                      "replayed_steps")}
for _name in COUNTERS.values():
    profiling.count(_name, 0)


def _stacked(out: dict) -> torch.Tensor:
    return torch.stack(list(out.values()))


class GraphedTrainStep:
    """`body(*inputs) -> {name: 0-dim tensor}` on CUDA inputs, eager the
    first time a key occurs, replayed from a captured graph after (see the
    module's docstring). Returns the body's outputs, fresh each call."""

    def __init__(self, body, generators=()):
        self.body = body
        self.generators = tuple(generators)
        self._graphs: dict = {}  # key -> (graph, static inputs, output)
        self._seen: set = set()
        self._names: dict = {}   # key -> the body's output names
        self._pool = None
        self.stream = None

    def __call__(self, *inputs: torch.Tensor) -> dict:
        device = inputs[0].device
        if device.type != "cuda":
            raise ValueError(f"a graphed training step needs CUDA inputs, "
                             f"not {device}")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        key = tuple((t.shape, t.dtype) for t in inputs)
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            if debugging.checks_active():
                out = self._run_eagerly(key, inputs)
            elif key in self._graphs:
                out = self._replay(key, inputs)
                profiling.count(COUNTERS["replayed_steps"])
            elif key in self._seen:
                self._capture(key, inputs)
                out = self._replay(key, inputs)
                profiling.count(COUNTERS["captured_steps"])
            else:
                out = self._run_eagerly(key, inputs)
                self._seen.add(key)
        caller.wait_stream(self.stream)
        return dict(zip(self._names[key], out.unbind()))

    def _run_eagerly(self, key, inputs) -> torch.Tensor:
        out = self.body(*inputs)
        self._names[key] = list(out)
        profiling.count(COUNTERS["eager_steps"])
        return _stacked(out)

    def _capture(self, key, inputs) -> None:
        static = [t.clone() for t in inputs]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=self._pool, stream=self.stream):
            out = self.body(*static)
            names = list(out)
            out = _stacked(out)
        self._graphs[key] = (graph, static, out)
        self._names[key] = names

    def _replay(self, key, inputs) -> torch.Tensor:
        graph, static, out = self._graphs[key]
        with profiling.span("train.replay"):
            for s, t in zip(static, inputs):
                s.copy_(t)
            graph.replay()
            return out.clone()
