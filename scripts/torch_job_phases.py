"""Where a benchmark cell's host time goes, phase by phase, from the port's
spans (`utils/profiling.py`), and what the spans cost.

    python3 scripts/torch_job_phases.py [--cell gan64_online] [--seed N] \\
        [--seconds 51] [--windows 2] [--device cuda]

It sets the cell up through its module in `benchmark/drivers/`, runs
`--windows` windows of `--seconds` (the first with the cell's own traced
stretch, the rest untraced) and reads the root spans of the window
from `profiling.spans()`: `sim.run_ensemble` a job online, `train.step` a
batch in training. Each root's time is split by phase: each span's own
time (its duration less its children's), summed by its path under the
root (`sim.advance/graph.capture`; the root's own time is `self`). A unit
is late when it takes over 1.1 times the window's median; for the late
units, each phase's excess over its median across the window's units. The
traced stretch's units are reported apart (the profiler's cost on a unit).
Last, the cost of one span with no profiler running and with one
recording. One JSON line a window, then one of costs, on standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import drivers, manifest  # noqa: E402
from pyqg_generative_torch.utils import profiling  # noqa: E402

ROOTS = ("sim.run_ensemble", "train.step")
LATE = 1.1


def phases(records) -> list:
    """[(root Span, {phase path: own ms})], one a root span, in order."""
    by_id = {r.span_id: r for r in records}
    child_ns = defaultdict(int)
    for r in records:
        if r.parent_id in by_id:
            child_ns[r.parent_id] += r.end_ns - r.start_ns
    split = defaultdict(lambda: defaultdict(float))
    for r in records:
        root = by_id.get(r.root_id)
        if root is None or root.name not in ROOTS:
            continue
        path, up = [], r
        while up.parent_id is not None and up.parent_id in by_id:
            path.append(up.name)
            up = by_id[up.parent_id]
        own = (r.end_ns - r.start_ns - child_ns[r.span_id]) / 1e6
        split[r.root_id]["/".join(reversed(path)) or "self"] += own
    return [(by_id[k], dict(v)) for k, v in split.items()]


def report(units: list, traced: tuple | None) -> dict:
    """The window's units (root, phases): medians, late units and their
    excess by phase; the traced units apart."""
    inside = [] if traced is None else [
        u for u in units if u[0].start_ns < traced[1]
        and u[0].end_ns > traced[0]]
    rest = [u for u in units if u not in inside]
    wall = [(r.end_ns - r.start_ns) / 1e6 for r, _ in rest]
    med = statistics.median(wall)
    names = sorted({k for _, p in rest for k in p})
    med_phase = {k: statistics.median(p.get(k, 0.0) for _, p in rest)
                 for k in names}
    late = [(w, {k: p.get(k, 0.0) - med_phase[k] for k in names})
            for w, (_, p) in zip(wall, rest) if w > LATE * med]
    excess = {k: sum(e[k] for _, e in late) for k in names}
    return {"units": len(rest), "median_ms": med,
            "mean_ms": statistics.fmean(wall), "max_ms": max(wall),
            "median_phase_ms": med_phase, "late": len(late),
            "late_excess_ms": sum(w - med for w, _ in late),
            "late_excess_by_phase_ms": _largest(excess),
            # each late unit: its time and its three largest excesses
            "late_units": [[w, _largest(e, 3)] for w, e in late],
            "traced_ms": [(r.end_ns - r.start_ns) / 1e6 for r, _ in inside]}


def _largest(ms: dict, n: int | None = None) -> dict:
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def span_cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    """ns a span, with no profiler running and with one recording."""
    t = time.perf_counter_ns()
    for _ in range(n_off):
        with profiling.span("cost"):
            pass
    off = (time.perf_counter_ns() - t) / n_off
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        t = time.perf_counter_ns()
        for _ in range(n_on):
            with profiling.span("cost"):
                pass
        on = (time.perf_counter_ns() - t) / n_on
    profiling.clear_spans()
    return {"span_ns_off": off, "span_ns_on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="gan64_online")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1601)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    man = manifest.load()
    cell = manifest.cell(man, args.cell)
    traffic = manifest.traffic(cell["traffic"])
    driver = drivers.load(traffic["driver"])(
        manifest.config(man, cell["config"]), traffic, args.seed,
        args.device, ROOT)
    driver.setup()
    # a full-length job: the set-up's shorter job is left out
    full = traffic.get("steps_per_snapshot", 0) * traffic.get("snapshots", 0)
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    for w in range(args.windows):
        profiling.clear_spans()
        traces = [] if w == 0 else None
        driver.window(args.seconds, traces)
        window = None
        if traces:
            lo, hi = traces[-1].window
            window = (lo * 1e3, hi * 1e3)
        units = [u for u in phases(profiling.spans())
                 if u[0].name == "train.step"
                 or u[0].attrs.get("steps") == full]
        print(json.dumps({"cell": args.cell, "seed": args.seed,
                          "device": card, "window": w,
                          **report(units, window)}), flush=True)
    print(json.dumps(span_cost()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
