"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is the one its `configs` entry gives, the traffic
mix is `traffic/<traffic>.json`, the cell's correctness limits
`limits/<cell>.json`, and each per-layer metric's reader
`layer_metrics/<metric>.py`. `problems` lists what breaks the manifest's
rules of names, units and references.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = SOURCES_E2E + ("program_span", "program_counter")


def load(path=None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in the manifest")


def cell(man: dict, name: str) -> dict:
    return _named(man["workloads"], name, "workload")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    return _read(root / _named(man["configs"], name, "config")["file"])


def traffic(name: str, here: Path = HERE) -> dict:
    return _read(here / "traffic" / f"{name}.json")


def limits(name: str, here: Path = HERE) -> dict:
    return _read(here / "limits" / f"{name}.json")


def metrics_of(man: dict, kind: str, cell_name: str) -> list:
    """The `end_to_end` or `per_layer` metrics reported in a cell."""
    return [m for m in man[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str, here: Path = HERE):
    """The `read(ctx)` of `layer_metrics/<metric>.py`."""
    path = here / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_layer_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(man: dict, root: Path = ROOT) -> list:
    """What in the manifest breaks its rules, as sentences; [] if
    nothing."""
    out = []
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in man[k]]
    for n in names + [w["traffic"] for w in man["workloads"]] + [
            k for c in man["configs"] for k in c["reduced"]]:
        if not NAME.fullmatch(n):
            out.append(f"name {n!r}")
    for k in ("configs", "workloads"):
        seen = [e["name"] for e in man[k]]
        if len(seen) != len(set(seen)):
            out.append(f"a name repeats in {k}")
    metric_names = [m["name"] for k in ("end_to_end", "per_layer")
                    for m in man[k]]
    if len(metric_names) != len(set(metric_names)):
        out.append("a metric name repeats")
    cells = {w["name"]: w for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: no config {w['config']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if not (root / "benchmark" / "traffic" / f"{w['traffic']}.json"
                ).exists():
            out.append(f"{w['name']}: no traffic file {w['traffic']!r}")
        if not (root / "benchmark" / "limits" / f"{w['name']}.json"
                ).exists():
            out.append(f"{w['name']}: no limits file")
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a pair of config and traffic repeats")
    for c in man["configs"]:
        if not (root / c["file"]).exists():
            out.append(f"config {c['name']}: no file {c['file']}")
        if not any(w["config"] == c["name"] for w in man["workloads"]):
            out.append(f"config {c['name']} is used by no cell")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for kind in ("end_to_end", "per_layer"):
        for m in man[kind]:
            if not UNIT.fullmatch(m["unit"]):
                out.append(f"{m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"{m['name']}: better {m['better']!r}")
            if m["source"] not in (SOURCES_E2E if kind == "end_to_end"
                                   else SOURCES):
                out.append(f"{m['name']}: source {m['source']!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    out.append(f"{m['name']}: no cell {c!r}")
    for m in man["end_to_end"]:
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in man["per_layer"]:
        target = e2e.get(m["moves"])
        if target is None:
            out.append(f"{m['name']}: moves {m['moves']!r}, no such "
                       "end-to-end metric")
            continue
        for c in m.get("workloads", list(cells)):
            if c not in target.get("workloads", list(cells)):
                out.append(f"{m['name']}: {c} does not report "
                           f"{m['moves']}")
        if not (root / "benchmark" / "layer_metrics" / f"{m['name']}.py"
                ).exists():
            out.append(f"{m['name']}: no reader")
    for c in cells:
        if len(metrics_of(man, "end_to_end", c)) < 2:
            out.append(f"{c}: reports setup_s alone")
        if not metrics_of(man, "per_layer", c):
            out.append(f"{c}: no per-layer metric")
    return out
