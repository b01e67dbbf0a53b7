"""Readings from which `gan64_train`'s correctness limits are set, on the
card: `calibrate.py`'s loop with this cell's controls.

    python3 benchmark/calibrate_gan.py --seeds 1 2 3 \\
        [--controls tf32 bfloat16 no_double_backward half_batch \\
         no_generator] [--seconds 0]

For each seed it sets the cell up, runs its window for `--seconds` (0: one
batch) and prints one JSON line of the numbers that the run's check
compares (`program`) and one with the worst leaf of each
(`program_detail`): the lower readings, from sound runs of the program.
Each control then prints its numbers for the same seed, the reference put
in the program's place and judged by the same comparison against the
float32 reference:

* `tf32`, `bfloat16`: computed with TF32 on, or with every convolution's
  input and weights rounded to bf16;
* `no_double_backward`: the gradient penalty's input gradient taken
  without a graph, so that the critic's update leaves the penalty out;
* `half_batch`: half of each batch left out, the means over the rest;
* `no_generator`: the generator's update left out.

The upper reading of a number is the smallest that the controls give.
Nothing here runs in a benchmark run.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FAULTS = {"tf32": {"mode": "tf32"}, "bfloat16": {"mode": "bfloat16"},
          "no_double_backward": {"double_backward": False},
          "half_batch": {"half": True},
          "no_generator": {"update_generator": False}}


def controls(driver, names) -> dict:
    """{run: numbers with their worst leaves} of the program and of each
    control, for one driver that has run its window."""
    from benchmark.drivers.gan_training import compare
    terms, grads, afters = driver.reference()
    befores = driver.states[:-1]
    out = {"program_detail": compare(
        driver.check_terms, driver.first_grad, befores, driver.states[1:],
        terms, grads, afters, detail=True)}
    for c in names:
        ct, cg, ca = driver.reference(**FAULTS[c])
        out[c] = compare(ct, cg[0], befores, ca, terms, grads, afters,
                         detail=True)
    return out


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import calibrate
    # calibrate.py picks the training cells' controls by that name
    calibrate._training_controls = controls
    args = sys.argv[1:] if argv is None else list(argv)
    return calibrate.main(["--workload", "gan64_train", *args])


if __name__ == "__main__":
    sys.exit(main())
