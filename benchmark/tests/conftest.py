"""Fixtures of the benchmark's CPU tests: the cells cut to a size the CPU
runs in seconds, and a run of a cell through `run.run` on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import manifest  # noqa: E402


def shrink_config(c: dict) -> dict:
    if "physics" in c:
        c["physics"]["nx"] = 16
    else:
        c["nx"] = 16
    return c


def shrink_traffic(t: dict) -> dict:
    if t["driver"] == "online_ensemble":
        t.update(members=2, steps_per_snapshot=6, snapshots=3,
                 warmup_snapshots=2, warmup_steps_per_snapshot=6,
                 check_jobs=2)
    else:
        t.update(samples=40, batch_size=8)
    return t


@pytest.fixture
def tiny(monkeypatch):
    """Every cell at 16^2: 2 members and 18 steps a job online, batches of
    8 from 40 samples in training."""
    config, traffic = manifest.config, manifest.traffic
    monkeypatch.setattr(manifest, "config", lambda *a, **k: shrink_config(
        config(*a, **k)))
    monkeypatch.setattr(manifest, "traffic", lambda *a, **k: shrink_traffic(
        traffic(*a, **k)))


@pytest.fixture
def run_cell(tiny):
    """run_cell(cell, seed=..., trace=0, man=None, root=ROOT) -> the result
    fields of one CPU run of the cell, its window 0.3 s."""
    from benchmark import run

    def go(cell, seed=2 ** 31 + 11, trace=0, man=None, root=ROOT):
        args = SimpleNamespace(workload=cell, seed=seed, seconds=0.3,
                               trace=trace)
        return run.run(args, torch.device("cpu"), man or manifest.load(),
                       root)
    return go
