"""The traced job's device-idle ms that its own per-job work costs: each
idle gap of the traced stretch (`yardstick.idle_gaps`) is named by the
innermost program span around its midpoint, and the gaps named
`sim.advance` or `sim.snapshot`, which fall between replayed steps, are
left out. The rest lie under the job's set-up and tear-down
(`sim.initial_conditions`, `sim.init_carry`, `graph.eager`,
`graph.capture`, `sim.finalize`, `sim.to_host`, `sim.dataset`, the root
`sim.run_ensemble` itself) or under no program span. Program spans are the
port's (`utils.profiling.span`), mirrored into the profiler's trace on its
clock; a program without them reads nothing."""
import numpy as np

PROGRAM = ("sim.", "graph.")
BETWEEN_REPLAYS = ("sim.advance", "sim.snapshot")


def read(ctx):
    t = ctx.trace
    if t is None or not any(h[0] == "sim.run_ensemble" for h in t.host):
        return None
    spans = [h for h in t.host if h[0].startswith(PROGRAM)]
    gaps = np.array(ctx.yardstick.idle_gaps(
        [(s, e) for _, s, e in t.device], t.window)).reshape(-1, 2)
    mid = gaps.mean(axis=1)[:, None]
    start = np.array([s for _, s, _ in spans])
    end = np.array([e for _, _, e in spans])
    # each gap's innermost program span: the shortest that holds its middle
    held = (start <= mid) & (mid <= end)
    width = np.where(held, end - start, np.inf)
    inner = width.argmin(axis=1)
    between = held.any(axis=1) & np.isin(
        np.array([spans[i][0] for i in inner]), BETWEEN_REPLAYS)
    return float((gaps[:, 1] - gaps[:, 0])[~between].sum()) / 1e3
