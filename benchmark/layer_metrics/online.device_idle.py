"""The device's idle share of the traced job: 1 - the union of its
operations' intervals over the traced stretch's wall span, from the
host's start mark to its end mark."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
