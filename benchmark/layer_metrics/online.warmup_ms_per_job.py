"""Host ms a job spends warming up its new `GraphedStep`: the traced
job's `graph.eager` spans (the steps run eagerly before and beside the
captures) and `graph.capture` spans (each capture with its graph pool and
`instantiate`), over the traced `sim.run_ensemble` jobs. Program spans are
the port's (`utils.profiling.span`); a program without them reads
nothing."""

WARMUP = ("graph.eager", "graph.capture")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    jobs = sum(h[0] == "sim.run_ensemble" for h in t.host)
    warm = [e - s for name, s, e in t.host if name in WARMUP]
    if not jobs or not warm:
        return None
    return sum(warm) / 1e3 / jobs
