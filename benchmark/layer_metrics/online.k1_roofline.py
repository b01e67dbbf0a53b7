"""K1's share of its roofline in the traced job: its least time a call
(the larger of its operations over 67 TFLOP/s, float32 outside the tensor
cores, and its bytes over 3.35 TB/s; `yardstick.k1_chain_cost`) over its
device time a call, summed from the trace by kernel name. A call is the
chain Conv_1..Conv_n, one launch a layer."""

KERNEL = "conv_fma_kernel"  # in the name of K1's float32 kernel


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps"):
        return None
    ops = ctx.trace.kernels(KERNEL)
    if not ops:
        return None
    cfg, ys = ctx.config, ctx.yardstick
    calls = len(ops) / (len(cfg["kernels"]) - 1)
    device_s = sum(e - s for _, s, e in ops) / 1e6 / calls
    flops, nbytes = ys.k1_chain_cost(cfg["model_args"]["hidden_channels"],
                                     cfg["physics"]["nx"],
                                     ctx.traffic["members"])
    least, _ = ys.least_seconds(flops, nbytes, ys.PEAK_FLOPS["float32"])
    return 100.0 * least / device_s
