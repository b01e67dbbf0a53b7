"""Tracing / profiling utilities.

Twin of `pyqg_generative_tpu/utils/profiling.py`. The reference's only
tracing is a wall-clock decorator (reference tools/cnn_tools.py:40-49),
kept as a copy. `trace(logdir)` is `torch.profiler` with CPU and, where a
card is present, CUDA activities, written as a Chrome trace into `logdir`
(the twin writes an xprof trace). `measure_throughput` times any
`carry -> carry` step (an eager step or a `sim.graph.GraphedStep`) on the
host clock between synchronisations of the carry's device, and returns the
twin's keys."""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from functools import wraps

import torch

__all__ = ["timer", "trace", "measure_throughput"]


def timer(func):
    """Print the wall-clock time of a call (reference tools/cnn_tools.py:40-49)."""
    @wraps(func)
    def wrap(*args, **kw):
        t1 = time.time()
        result = func(*args, **kw)
        t2 = time.time()
        print(f"Function {func.__name__!r} executed in {(t2 - t1):.4f}s")
        return result
    return wrap


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the context; on exit the Chrome trace (open it
    in chrome://tracing or Perfetto) is `logdir/trace.json`. Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
