"""The step loop's replayed share: steps replayed from a captured CUDA
graph over all steps (eager, captured, replayed), from the counters of
`sim/graph.py` as deltas over the window."""


def read(ctx):
    c = ctx.counters
    total = sum(c.get(k, 0) for k in ("eager_steps", "captured_steps",
                                      "replayed_steps"))
    if not total:
        return None
    return 100.0 * c["replayed_steps"] / total
