"""The GAN's whole training step's share of the card's float32 peak (67
TFLOP/s, the training step's precision: TF32 off): its operations a sample
(`gan_flops.gan_train_flops_per_sample`, which states its rule for the
gradient penalty's double backward), critic-only and generator batches
weighted by the window's share of generator batches (the counter
`train.generator_steps` over the window's batches), times the samples a
second of the traced run's untraced batches, on the host clock. A program
without the counter reads nothing."""
from benchmark import gan_flops


def read(ctx):
    rate = ctx.work.get("untraced_rate")
    batches = ctx.work.get("window_batches")
    steps = ctx.counters.get("generator_steps")
    if not rate or not batches or steps is None:
        return None
    cfg = ctx.config
    flops = gan_flops.gan_train_flops_per_sample(
        cfg["model_args"]["hidden_channels"], cfg["nx"], steps / batches,
        cfg["critic"]["channels"][0], cfg["n_latent"])
    return 100.0 * flops * rate / ctx.yardstick.PEAK_FLOPS["float32"]
