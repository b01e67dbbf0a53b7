"""A traced stretch of a run: `torch.profiler` with CPU and CUDA
activities, reduced to the device's operations, the host's spans and the
stretch's host marks.

The benchmark's own spans (`span(name)`) mark the calls into each layer
from the harness's side; the profiler adds the program's operators and
runtime calls. Times are microseconds on the profiler's clock, which the
host's spans and the device's operations share.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from . import yardstick

MARK = "benchmark.traced"


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler when one
    runs (and nearly free when none does)."""
    return torch.profiler.record_function(name)


@dataclass
class Trace:
    """Device operations and host spans: (name, start_us, end_us)."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self, *needles: str) -> list:
        """Device operations whose lower-case name holds any needle (all,
        without needles)."""
        if not needles:
            return list(self.device)
        return [d for d in self.device
                if any(n in d[0].lower() for n in needles)]

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        return yardstick.busy_share([(s, e) for _, s, e in self.device],
                                    self.window) * self.window_s

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps, each named by the innermost host span around its
        middle."""
        totals: dict = {}
        for name, s, e in _clip_named(self.device, self.window):
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        gaps = yardstick.idle_gaps([(s, e) for _, s, e in self.device],
                                   self.window)[:top]
        named = []
        for lo, hi in gaps:
            mid = (lo + hi) / 2
            around = [h for h in self.host if h[1] <= mid <= h[2]
                      and h[0] != MARK]
            label = min(around, key=lambda h: h[2] - h[1])[0] if around \
                else "no host span"
            named.append([f"host: {label[:150]}", (hi - lo) / 1e6])
        return {"device_ops": [[n[:150], s] for n, s in ops],
                "idle_gaps": named}


def _clip_named(ops, window):
    lo, hi = window
    return [(n, max(s, lo), min(e, hi)) for n, s, e in ops
            if e > lo and s < hi]


def _events(prof):
    """(device ops, host spans) of a finished profiler."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e3
        item = (ev.name(), s, s + ev.duration_ns() / 1e3)
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif not ev.is_user_annotation():
            # a span's copy on the device's timeline is no operation
            device.append(item)
    return device, host


@contextlib.contextmanager
def traced(result: list):
    """Trace the body; on exit append its `Trace` to `result`. The body's
    device work is synchronised inside the marks, so that the window's end
    is the end of its last operation's wait."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    device, host = _events(prof)
    marks = [h for h in host if h[0] == MARK]
    window = (marks[0][1], marks[0][2]) if marks else (
        min((s for _, s, _ in device + host), default=0.0),
        max((e for _, _, e in device + host), default=0.0))
    result.append(Trace(device=device, host=host, window=window))
