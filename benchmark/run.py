"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It sets up the cell (the `setup_s` metric: imports, loading, warming up
and, on a checkout's first run, the kernels' build), drives the cell's
entry for `--seconds`, frees the program's state, checks what the window
produced against the plain reference, and prints, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`; with
`--trace 1` its per-layer metrics, from a traced stretch of the window),
`device` and, traced, `breakdown`; last, `checks`: each number compared
with its limit, which also end standard error.

It exits 2 and prints no result where there is no CUDA card (or fewer
than the cell asks for), and 3 where JAX or the JAX package was loaded.
Caches stay inside the checkout: the port builds its kernels into its own
`pyqg_generative_torch/build/`, and any extension or Triton cache goes to
`build/benchmark/`.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# (set-up phase, perf_counter at its end), before the driver's own
MARKS: list = []


def _cache_dirs() -> None:
    cache = ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _card(count: int) -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit": smi[0].split(",")[-1].strip() if smi else None}


def layer_metrics(man: dict, cell: str, ctx, here: Path) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    from benchmark import manifest
    out = {}
    for m in manifest.metrics_of(man, "per_layer", cell):
        value = manifest.reader(m["name"], here)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(args, device, man: dict, root: Path = ROOT) -> dict:
    """Set up, drive the window, check; the result's fields. `root` is
    the checkout that holds the manifest's files."""
    from benchmark import drivers, manifest
    here = root / "benchmark"
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"], root)
    traffic = manifest.traffic(cell["traffic"], here)
    limits = manifest.limits(cell["name"], here)["limits"]
    driver = drivers.load(traffic["driver"])(config, traffic, args.seed,
                                             device, root)
    driver.setup()
    setup_s = time.perf_counter() - T0
    marks = [("start", T0)] + MARKS + driver.marks
    print("setup phases, s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (_, prev), (name, t) in
        zip(marks, marks[1:])), file=sys.stderr)
    traces = [] if args.trace else None
    win = driver.window(args.seconds, traces)
    out = {"attempted": win.attempted, "failed": win.failed}
    if device.type == "cuda":
        out["device"] = _card(cell["chips"])
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if args.trace:
        from benchmark import yardstick
        trace = traces[-1] if traces else None
        ctx = SimpleNamespace(trace=trace, work=win.traced_work,
                              counters=win.counters, config=config,
                              traffic=traffic, yardstick=yardstick)
        out["metrics"] = layer_metrics(man, cell["name"], ctx, here)
        if trace is not None:
            out["device"]["busy_s"] = trace.busy_s()
            out["device"]["window_s"] = trace.window_s
            out["breakdown"] = trace.breakdown()
    else:
        values = {"setup_s": setup_s, **win.end_to_end}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in manifest.metrics_of(man, "end_to_end",
                                                       cell["name"])}
    if win.units:
        print(f"units {len(win.units)}, seconds each: "
              + " ".join(f"{u:.4f}" for u in win.units), file=sys.stderr)
    driver.release()
    numbers = driver.check()
    out["correct"] = bool(win.failed == 0 and numbers and all(
        v <= limits[k] for k, v in numbers.items()))
    # a number that is not finite is written as a string: JSON has none
    checks = {k: {"value": v if math.isfinite(v) else str(v),
                  "limit": limits[k]} for k, v in numbers.items()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark import manifest
    man = manifest.load()
    chips = manifest.cell(man, args.workload)["chips"]

    import torch
    MARKS.append(("torch", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run(args, torch.device("cuda"), man)
    from benchmark import guard
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"loaded in the run's process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    # `checks` last, as the result's last key
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
