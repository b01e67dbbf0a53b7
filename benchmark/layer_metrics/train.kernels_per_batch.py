"""Kernels the host launches a batch: the traced batches' device
operations that are kernels (not copies or fills), over the batches."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("batches"):
        return None
    kernels = [d for d in ctx.trace.device
               if not d[0].lower().startswith(("memcpy", "memset"))]
    return len(kernels) / ctx.work["batches"]
