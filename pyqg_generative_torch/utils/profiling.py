"""Tracing / profiling utilities.

Twin of `pyqg_generative_tpu/utils/profiling.py`. The reference's only
tracing is a wall-clock decorator (reference tools/cnn_tools.py:40-49),
kept as a copy that also waits for the card. `trace(logdir)` is
`torch.profiler` with CPU and, where a card is present, CUDA activities,
written as a Chrome trace into `logdir` (the twin writes an xprof trace).
`measure_throughput` times any `carry -> carry` step (an eager step or a
`sim.graph.GraphedStep`) on the host clock between synchronisations of the
carry's device, and returns the twin's keys.

The port's own instrumentation lives here too:

* **Spans.** `with span(name, **attrs):` marks a phase of the program at a
  layer's boundary (never once per replayed step or kernel launch). Each
  span is kept as a `Span` record in one bounded in-process buffer
  (`spans()`, `clear_spans()`), stamped with `time.time_ns()`, the clock
  `torch.profiler` stamps its events with. A span's parent is the
  innermost span open on the same thread; a span opened with none is a
  root, and every span under it carries its id as `root_id` (one
  `run_ensemble` job, one trainer batch). While a profiler records, a span
  also opens `torch.profiler.record_function(name)`, so it lands in the
  same trace as the device's operations; with none recording it costs two
  clock reads, a flag check and an append.
* **Counters.** `count(name, n)` adds to a named counter of the process;
  `counters()` is a snapshot, `reset_counters()` sets every counter to 0.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from functools import wraps
from typing import NamedTuple

import torch

__all__ = ["timer", "trace", "measure_throughput", "Span", "span", "spans",
           "clear_spans", "SPAN_BUFFER", "count", "counters",
           "reset_counters"]


def timer(func):
    """Print the wall-clock time of a call (reference
    tools/cnn_tools.py:40-49). Unlike the reference's timer, the second
    clock read waits for the CUDA device where one is in use, so that a
    call that enqueues work on the card is timed to the end of that work,
    not of its enqueue."""
    @wraps(func)
    def wrap(*args, **kw):
        t1 = time.time()
        result = func(*args, **kw)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t2 = time.time()
        print(f"Function {func.__name__!r} executed in {(t2 - t1):.4f}s")
        return result
    return wrap


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the context; on exit the Chrome trace (open it
    in chrome://tracing or Perfetto) is `logdir/trace.json`. Yields the
    profiler. The program's spans appear in it by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ------------------------------------------------------------------ spans
SPAN_BUFFER = 65536   # records kept; the oldest go first


class Span(NamedTuple):
    """One finished span: stamps in ns of `time.time_ns()`; `parent_id` is
    None for a root, whose `root_id` is its own `span_id`."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    root_id: int
    attrs: dict


_SPANS: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_IDS = itertools.count(1)
_OPEN = threading.local()
_profiling = torch._C._autograd._profiler_enabled
_time_ns = time.time_ns


class span:
    """A span of the program (see the module's docstring): a context
    manager that keeps a `Span` record when it closes and, while a
    profiler records, mirrors itself as a `record_function`."""
    __slots__ = ("name", "attrs", "_id", "_parent", "_root", "_start",
                 "_mirror")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        try:
            stack = _OPEN.stack
        except AttributeError:
            stack = _OPEN.stack = []
        self._id = next(_IDS)
        if stack:
            self._parent, self._root = stack[-1]._id, stack[-1]._root
        else:
            self._parent, self._root = None, self._id
        stack.append(self)
        self._mirror = None
        # the stamps bracket the mirror, so the record holds its event
        self._start = _time_ns()
        if _profiling():
            self._mirror = torch.autograd.profiler.record_function(self.name)
            self._mirror.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        end = _time_ns()
        _OPEN.stack.pop()
        _SPANS.append((self.name, self._start, end, self._id, self._parent,
                       self._root, self.attrs))
        return False


def spans() -> list:
    """The buffer's `Span` records, oldest first (at most SPAN_BUFFER)."""
    return [Span._make(r) for r in _SPANS]


def clear_spans() -> None:
    _SPANS.clear()


# --------------------------------------------------------------- counters
_COUNTS: dict = {}


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (0 declares it)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter: {name: value}."""
    return dict(_COUNTS)


def reset_counters() -> None:
    """Every counter to 0."""
    for name in _COUNTS:
        _COUNTS[name] = 0


def _device_of(carry):
    """The device of the first tensor in a carry (tuples, lists, dicts,
    dataclasses), or None."""
    if isinstance(carry, torch.Tensor):
        return carry.device
    if dataclasses.is_dataclass(carry) and not isinstance(carry, type):
        carry = [getattr(carry, f.name) for f in dataclasses.fields(carry)]
    elif isinstance(carry, dict):
        carry = list(carry.values())
    if isinstance(carry, (tuple, list)):
        for c in carry:
            d = _device_of(c)
            if d is not None:
                return d
    return None


def _sync(device):
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_throughput(step_fn, carry, n_steps: int = 100,
                       warmup: int = 3) -> dict:
    """Throughput of a `carry -> carry` step function after `warmup` steps
    (which build, capture and compile what they need). Returns steps/sec and
    ms/step."""
    device = _device_of(carry)
    for _ in range(warmup):
        carry = step_fn(carry)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        carry = step_fn(carry)
    _sync(device)
    dt = time.perf_counter() - t0
    return {"steps_per_s": n_steps / dt, "ms_per_step": 1e3 * dt / n_steps,
            "wall_s": dt}
