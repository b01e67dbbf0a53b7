"""Verbatim copy of `pyqg_generative_tpu/parallel/sweep.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Device-parallel experiment sweeps — the TPU replacement for the
reference's SLURM orchestration (reference scripts/slurm_helpers.py,
run_reference.py, run_parameterized.py).

Where the reference submits one process per (model, operator, resolution,
seed, member), here a sweep is a python loop over *configurations* whose
inner ensembles are vmapped+sharded over the chip mesh, and results land as
per-config .npz datasets in the same folder layout the reference uses."""
from __future__ import annotations

import itertools
import os
from typing import Callable, Mapping, Sequence

from ..utils import xrlite as xr

__all__ = ["run_experiment", "product_configs"]


def product_configs(**axes: Sequence) -> list[dict]:
    """Cartesian product of named option lists -> list of config dicts
    (the reference builds this with nested shell loops over sbatch calls)."""
    names = list(axes.keys())
    return [dict(zip(names, combo))
            for combo in itertools.product(*axes.values())]


def run_experiment(folder: str, fn: Callable[..., xr.Dataset],
                   configs: Sequence[Mapping], name_fn=None,
                   skip_existing: bool = True, verbose: bool = True):
    """Run `fn(**config) -> Dataset` for every config, saving each result to
    `{folder}/{name}.npz`. Mirrors the reference's mkdir+submit+skip-existing
    behavior (scripts/slurm_helpers.py:89-104, train_parameterizations.py
    weight-exists skip)."""
    os.makedirs(folder, exist_ok=True)
    results = {}
    for cfg in configs:
        name = name_fn(cfg) if name_fn else \
            "-".join(str(v) for v in cfg.values())
        path = os.path.join(folder, f"{name}.npz")
        if skip_existing and os.path.exists(path):
            if verbose:
                print(f"[sweep] skip existing {name}")
            results[name] = path
            continue
        if verbose:
            print(f"[sweep] run {name}")
        ds = fn(**cfg)
        if ds is not None:
            ds.to_npz(path)
        results[name] = path
    return results
