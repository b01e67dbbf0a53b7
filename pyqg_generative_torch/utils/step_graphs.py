"""A step captured as CUDA graphs and replayed: the core under
`sim/graph.py::GraphedStep` (an online step) and
`ml/train_graph.py::GraphedTrainStep` (a training step), whose kernels the
host takes longer to enqueue than the card takes to run. A wrapper computes
each call's key (the step's host decisions, its inputs' shapes) and hands
`run` the body and what a replay does; the core runs the call eagerly,
captures it or replays it. A replay launches the eager step's kernels, in
its order, with its arguments.

* **Decision** (`run`): eager while `utils.debugging.debug_nans`, whose
  checks read the device, is open; else a replay where the key has a graph;
  else a capture, replayed at once, where the key has been seen and
  `warmup` eager steps have run in all; else eager, and the key is seen.
  Eager steps make what a capture may not: cuFFT's plans, cuDNN's and
  cuBLAS's algorithms, handles and workspaces, the kernels' libraries and
  per-stream buffers.
* **Stream.** A call runs on the core's stream of its device, which waits
  for the caller's stream (`enter`) and is waited for after (`leave`). A
  CPU input raises.
* **Capture** records the body into a graph of its own, in the core's
  pool, made at the first capture, which holds one step's intermediates
  for the core's life. `generators` are registered with every graph, so a
  replay draws what an eager step would and moves them on as it would. A
  graph reads the arguments it was captured with, its tensor arguments
  cloned first, and writes what the body returned then (`Captured`).
  `on_capture(g, before)`, where given, runs inside the capture, after the
  graph's instantiation and before it is kept, with the counters as they
  stood before the capture; only then is the `cudaGraph_t` kept
  (`raw_cuda_graph`). `reset` drops the graphs,
  the seen keys and the eager count.
* **Counters** (`utils.profiling`) `<prefix>.eager_steps`,
  `.captured_steps` and `.replayed_steps`: a capture counts as captured
  and its replay as replayed, so eager + replayed are the calls. **Spans**
  `<prefix>.eager`, `<prefix>.capture` (the pool's creation and
  instantiation included) and `<prefix>.reset`; the core opens none on a
  replay, so the gaps between replays stay the caller's span's.
* **Failure raises.** A capture that meets a host read of the device or
  another call that stream capture refuses raises, as does a replay that
  fails. There is no fallback to the eager step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import debugging, profiling

__all__ = ["StepGraphs", "Captured", "counter_names"]


def counter_names(prefix: str) -> dict:
    """{"eager_steps": "<prefix>.eager_steps", ...}, each declared at 0."""
    names = {k: f"{prefix}.{k}" for k in ("eager_steps", "captured_steps",
                                          "replayed_steps")}
    for name in names.values():
        profiling.count(name, 0)
    return names


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple   # the arguments the body was captured with
    out: object     # what the body returned under capture


class StepGraphs:
    """The graphs of one wrapped step (see the module's docstring)."""

    def __init__(self, prefix: str, warmup: int, generators=(),
                 on_capture=None):
        self.warmup = warmup
        self.generators = tuple(generators)
        self.on_capture = on_capture
        self.graphs: dict = {}   # key -> Captured
        self.stream = None
        self._seen: set = set()
        self._eager = 0
        self._pool = None
        self._eager_steps, self._captured_steps, self._replayed_steps = (
            f"{prefix}.{k}_steps" for k in ("eager", "captured", "replayed"))
        self._spans = {k: f"{prefix}.{k}" for k in ("eager", "capture",
                                                     "reset")}

    def enter(self, device: torch.device) -> torch.cuda.Stream:
        """The caller's stream, which the core's now waits for."""
        if device.type != "cuda":
            raise ValueError(f"a graphed step needs CUDA inputs, not "
                             f"{device}")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        return caller

    def leave(self, caller: torch.cuda.Stream) -> None:
        caller.wait_stream(self.stream)

    def run(self, key, body, args: tuple, replay):
        """The call of `key`: `body(*args)`, eager, or `replay(g, *args)`,
        which launches `g.graph`, `g` the key's `Captured`, captured first
        where it has none (see the module's docstring)."""
        if not debugging.checks_active():
            g = self.graphs.get(key)
            if g is None and key in self._seen \
                    and self._eager >= self.warmup:
                g = self._capture(key, body, args)
            if g is not None:
                out = replay(g, *args)
                profiling.count(self._replayed_steps)
                return out
        with profiling.span(self._spans["eager"]):
            out = body(*args)
        self._seen.add(key)
        self._eager += 1
        profiling.count(self._eager_steps)
        return out

    def _capture(self, key, body, args) -> Captured:
        keep = self.on_capture is not None
        with profiling.span(self._spans["capture"]):
            before = profiling.counters() if keep else None
            args = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
            graph = torch.cuda.CUDAGraph(keep_graph=keep)
            for gen in self.generators:
                graph.register_generator_state(gen)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self.stream):
                out = body(*args)
            g = Captured(graph, args, out)
            if keep:
                graph.instantiate()
                self.on_capture(g, before)
        self.graphs[key] = g
        profiling.count(self._captured_steps)
        return g

    def reset(self) -> None:
        with profiling.span(self._spans["reset"]):
            self.graphs.clear()
            self._seen.clear()
            self._eager = 0
