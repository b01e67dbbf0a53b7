"""Readings from which a cell's correctness limits are set, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--controls tf32 bfloat16 program_bfloat16 half_batch] \\
        [--seconds 0]

For each seed it sets the cell up, runs its window for `--seconds` (0: one
unit of work, or as many as the check samples) and prints one JSON line of
the numbers that the run's check compares: the lower readings, from sound
runs of the program. Each control then prints its numbers for the same
seed, judged by the same comparison against the float32 reference:

* `tf32`, `bfloat16`: the reference put in the program's place, computed
  with TF32 on, or with every convolution's input and weights rounded to
  bf16;
* `program_bfloat16` (online): the program's own bf16 path, K1-bf16
  (`inference_dtype="bfloat16"`), on the same jobs;
* `half_batch` (training): the reference put in the program's place with
  half of each batch left out and the mean taken over the rest.

The upper reading of a number is the smallest that the controls give.
Nothing here runs in a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _online_controls(driver, controls) -> dict:
    if not controls:
        return {}
    from benchmark.drivers.online_ensemble import compare
    jobs = [driver.jobs[i] for i in driver.sample()]
    ref = driver.reference(jobs)
    out = {}
    for c in controls:
        if c in ("tf32", "bfloat16"):
            out[c] = compare(driver.reference(jobs, c), ref)
        elif c == "program_bfloat16":
            from pyqg_generative_torch.models import load_model
            driver.model = load_model(
                str(driver.root / driver.cfg["folder"]),
                device=driver.device, inference_dtype="bfloat16",
                online_variant=driver.cfg["online_variant"])
            outs = []
            for key, _ in jobs:
                ds = driver._job(driver.p, key,
                                 driver.tr["steps_per_snapshot"])
                outs.append({k: ds[k].values for k in ds.keys()
                             if k != "time"})
            driver.release()
            out[c] = compare(outs, ref)
    return out


def _training_controls(driver, controls) -> dict:
    from benchmark.drivers.training import compare
    losses, grads, state = driver.reference()
    out = {"program_detail": compare(
        driver.check_terms, driver.first_grad, driver.start, driver.after,
        losses, grads, state, detail=True)}
    for c in controls:
        if c in ("tf32", "bfloat16"):
            lc, gc, sc = driver.reference(c)
        elif c == "half_batch":
            lc, gc, sc = driver.reference(half=True)
        else:
            continue
        out[c] = compare(lc, gc, driver.start, sc, losses, grads, state,
                         detail=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import drivers, manifest
    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    Driver = drivers.load(traffic["driver"])
    controls = (_online_controls if traffic["driver"] == "online_ensemble"
                else _training_controls)
    for seed in args.seeds:
        driver = Driver(config, traffic, seed, torch.device("cuda"), ROOT)
        driver.setup()
        driver.window(args.seconds)
        driver.release()
        print(json.dumps({"cell": cell["name"], "seed": seed,
                          "run": "program", **driver.check()}), flush=True)
        for name, numbers in controls(driver, args.controls).items():
            print(json.dumps({"cell": cell["name"], "seed": seed,
                              "run": name, **numbers}), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
