"""The benchmark of the PyTorch and CUDA port, `pyqg_generative_torch`.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once, on the card it is
started on, and prints one JSON line. Everything that belongs to one
configuration, traffic mix, cell limit or per-layer metric is a file of its
own, found by its name:

* `configs/<config>.json`: the model and its solver, as run;
* `traffic/<mix>.json`: the parameters that a driver of `drivers/` reads
  (the file's `driver` key names it);
* `limits/<cell>.json`: the limits of the cell's correctness numbers, with
  the readings they were set from;
* `layer_metrics/<metric>.py`: one per-layer metric, `read(ctx)`.

The yardstick (`yardstick.py`, `tracing.py`, `inputs.py` and the plain
reference under `reference/`) lives here too, where the program cannot
change it. Nothing here imports JAX or the JAX package; `reference/`
imports nothing of the port.
"""
