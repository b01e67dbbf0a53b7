"""The whole online step's share of the card's float32 peak (67 TFLOP/s):
the closure's operations a member-step, from the AndrewCNN's weight
shapes (`yardstick.closure_flops_per_member_step`; the solver's FFTs are
not counted), times the member-steps a second of the traced run's
untraced jobs, on the host clock (the profiler slows its own job)."""


def read(ctx):
    rate = ctx.work.get("untraced_rate")
    if not rate:
        return None
    cfg, ys = ctx.config, ctx.yardstick
    flops = ys.closure_flops_per_member_step(
        cfg["model_args"]["hidden_channels"], cfg["physics"]["nx"])
    return 100.0 * flops * rate / ys.PEAK_FLOPS["float32"]
