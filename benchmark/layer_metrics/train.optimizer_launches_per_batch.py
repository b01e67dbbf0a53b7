"""Kernels the optimizer launches a batch: the traced batches' CUDA
runtime and driver launch calls (`cudaLaunch*`, `cuLaunch*`) that lie
inside a `train.optimizer` span (`ml/train.py::Adam.step`), over the
batches. Program spans are the port's (`utils.profiling.span`); a program
without them reads nothing."""
import bisect

LAUNCH = ("cudaLaunch", "cuLaunch")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.work.get("batches"):
        return None
    opt = sorted((s, e) for name, s, e in t.host if name == "train.optimizer")
    if not opt:
        return None
    starts = [s for s, _ in opt]
    n = 0
    for name, s, e in t.host:
        if name.startswith(LAUNCH):
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and e <= opt[i][1]
    return n / ctx.work["batches"]
