"""The general generators that traffic files drive, one module each; a
traffic file's `driver` key names its module here.

A module exposes `Driver(config, traffic, seed, device, root)` with:

* `setup()`: load the program and warm up every shape the traffic uses;
* `window(seconds, trace)`: drive the entry for `seconds`, finishing the
  unit of work under way; with `trace` (a list), trace one steady stretch
  into it. Returns a `Window`;
* `release()`: free the program's state;
* `check()`: the correctness numbers, {name: value}, of what the window
  produced against the plain reference.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass
class Window:
    end_to_end: dict                 # metric name -> value
    attempted: int
    failed: int
    counters: dict = field(default_factory=dict)   # deltas over the window
    units: list = field(default_factory=list)      # seconds of each unit
    # work done in the traced stretch, whose wall span is its trace's window
    traced_work: dict = field(default_factory=dict)


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}").Driver
