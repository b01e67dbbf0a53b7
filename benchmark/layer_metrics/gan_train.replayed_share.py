"""The GAN's training steps replayed from a captured CUDA graph over all
its steps (eager and replayed; a capture counts as replayed too, so these
are the calls), from the counters `train.eager_steps` and
`train.replayed_steps` of `utils/step_graphs.py`, as deltas over the
window, in percent. A program without them reads nothing."""


def read(ctx):
    c = ctx.counters
    if "replayed_steps" not in c:
        return None
    total = c.get("eager_steps", 0) + c["replayed_steps"]
    return 100.0 * c["replayed_steps"] / total if total else None
