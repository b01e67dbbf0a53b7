"""The training convolutions' device time: ms a batch in GEMM and
im2col / col2im kernels, by name, over the traced batches."""

NEEDLES = ("gemm", "im2col", "col2im")


def read(ctx):
    if ctx.trace is None or not ctx.work.get("batches"):
        return None
    ops = ctx.trace.kernels(*NEEDLES)
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / 1e3 / ctx.work["batches"]
