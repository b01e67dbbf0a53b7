"""The yardstick's arithmetic against hand counts."""
import numpy as np
import pytest

from benchmark import tracing, yardstick as ys

HIDDEN = (128, 64, 32, 32, 32, 32, 32)


def test_closure_flops_match_the_committed_weights():
    """The configuration's widths give the FLOPs that the committed
    generator's kernels (HWIO) give, as `bench_torch._conv_flops` counts
    them."""
    from conftest import ROOT

    from benchmark.reference.cnn import read_weights
    tree = read_weights(str(ROOT / "trained_models" / "eddy_gan_64" /
                            "G.msgpack"))["params"]
    by_weights = sum(2.0 * np.prod(layer["kernel"].shape) * 64 * 64
                     for name, layer in tree.items()
                     if name.startswith("Conv"))
    assert ys.closure_flops_per_member_step(HIDDEN, 64) == by_weights


def test_closure_flops_by_hand():
    per_pixel = 2 * (25 * 4 * 128 + 25 * 128 * 64 + 9 * 64 * 32
                     + 4 * 9 * 32 * 32 + 9 * 32 * 2)
    assert per_pixel == 546944
    assert ys.closure_flops_per_member_step(HIDDEN, 64) == per_pixel * 4096


def test_k1_chain_cost_by_hand():
    flops, nbytes = ys.k1_chain_cost(HIDDEN, 64, 10)
    assert flops == pytest.approx(21.35e9, rel=1e-3)  # chip_smoke's 21.35
    weights = (25 * 128 * 64 + 64) + (9 * 64 * 32 + 32) \
        + 4 * (9 * 32 * 32 + 32) + (9 * 32 * 2 + 2)
    assert nbytes == 4 * (10 * 4096 * (128 + 2) + weights)
    least, by = ys.least_seconds(flops, nbytes, ys.PEAK_FLOPS["float32"])
    assert by == "operations"
    assert least == pytest.approx(0.3187e-3, rel=1e-3)


def test_vae_training_flops_rule():
    f_enc = ys.layers_flops(ys.andrew_layers(4, 4, HIDDEN), 64, 64)
    f_dec = ys.layers_flops(ys.andrew_layers(4, 2, HIDDEN), 64, 64)
    f_enc0 = 2 * 25 * 4 * 128 * 4096
    assert ys.vae_train_flops_per_sample(HIDDEN, 64) == \
        3 * (f_enc + f_dec) - f_enc0
    assert ys.vae_train_flops_per_sample(HIDDEN, 64) == pytest.approx(
        13.35e9, rel=1e-3)


def test_union_and_busy_share_of_a_hand_made_trace():
    kernels = [(10, 20), (15, 25), (40, 50), (45, 48), (90, 130)]
    assert ys.union_us(kernels) == 15 + 10 + 40
    # the window runs from the host's mark at 0 to its mark at 100: the
    # idle edges count, and the part of the last kernel past 100 does not
    assert ys.busy_share(kernels, (0, 100)) == pytest.approx(0.35)
    # the old denominator, first kernel start to last kernel end, reads
    # 65 / 120
    assert ys.union_us(kernels) / (130 - 10) == pytest.approx(65 / 120)
    assert ys.idle_gaps(kernels, (0, 100)) == [(50, 90), (25, 40), (0, 10)]


def test_trace_breakdown_names_gaps_by_the_innermost_host_span():
    t = tracing.Trace(
        device=[("k_a", 10, 20), ("k_b", 30, 60), ("k_a", 70, 75)],
        host=[(tracing.MARK, 0, 80), ("outer", 0, 80),
              ("inner", 20, 30)],
        window=(0, 80))
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["k_b", "k_a"]
    assert [s for _, s in b["device_ops"]] == pytest.approx([30e-6, 15e-6])
    # gaps 0-10 and 60-70 under "outer" alone, 20-30 under "inner" too,
    # and 75-80 last
    assert sorted(n for n, _ in b["idle_gaps"][:3]) == [
        "host: inner", "host: outer", "host: outer"]
    assert [s for _, s in b["idle_gaps"]] == pytest.approx(
        [1e-5, 1e-5, 1e-5, 5e-6])
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.window_s == pytest.approx(80e-6)
