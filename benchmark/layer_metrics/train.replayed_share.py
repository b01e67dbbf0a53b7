"""The training step's replayed share: the traced batches' `train.step`
spans that hold a `train.replay` span (a step replayed from a captured
CUDA graph, `ml/train_graph.py`), over all their `train.step` spans, in
percent. Program spans are the port's (`utils.profiling.span`): steps
without replays read 0, a trace without `train.step` spans nothing."""
import bisect


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    steps = [(s, e) for name, s, e in t.host if name == "train.step"]
    if not steps:
        return None
    replays = sorted(s for name, s, _ in t.host if name == "train.replay")
    replayed = sum(bisect.bisect_right(replays, e)
                   > bisect.bisect_left(replays, s) for s, e in steps)
    return 100.0 * replayed / len(steps)
