"""Training convolutions a batch whose weight gradient took the split
route (`ml/train_conv.py`: cuDNN's forward and input gradient, PyTorch's
own weight gradient): the traced batches' `train.conv_wgrad` spans over
the batches. Program spans are the port's (`utils.profiling.span`); a
program without the route reads nothing."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.work.get("batches"):
        return None
    n = sum(name == "train.conv_wgrad" for name, _, _ in t.host)
    return n / ctx.work["batches"] if n else None
