"""The whole training step's share of the card's float32 peak (67
TFLOP/s, the training step's precision: TF32 off): the sigma-VAE's
operations a sample (`yardstick.vae_train_flops_per_sample`, which states
its rule for the backward pass) times the samples a second of the traced
run's untraced batches, on the host clock (the profiler slows the traced
batches by a third or more: the step launches about 10,000 kernels)."""


def read(ctx):
    rate = ctx.work.get("untraced_rate")
    if not rate or ctx.config["model_args"]["model"] != "CVAERegression":
        return None
    cfg, ys = ctx.config, ctx.yardstick
    flops = ys.vae_train_flops_per_sample(
        cfg["model_args"]["hidden_channels"], cfg["nx"], cfg["n_latent"])
    return 100.0 * flops * rate / ys.PEAK_FLOPS["float32"]
