"""The solver's cuFFT time: device ms a step in kernels whose name holds
"fft", over the traced job's steps."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps"):
        return None
    ops = ctx.trace.kernels("fft")
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / 1e3 / ctx.work["steps"]
