"""The `gan64_train` cell at 16^2 on the CPU: correct against the plain
reference (`reference/gan.py`) through `run.run`; the reference in bf16 put
in the program's place fails the cell's limits; a run with the timed path
broken underneath comes out not correct, once for each fault that the
GAN's step can have (the gradient penalty's double backward left out, half
of each batch left out, the generator's update skipped, the critic's Adam
count not advanced, the generator's advanced on every batch, the Adams'
moments not written back into the optimizer's state); the four
per-layer readers on hand-built traces and counters; and the step's
operations (`gan_flops.py`) against `torch.utils.flop_counter` over the
reference's period."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, shrink_config, shrink_traffic

from benchmark import drivers, gan_flops, inputs, manifest, tracing, \
    yardstick
from benchmark.drivers.gan_training import compare, critic_variables
from benchmark.reference import precision
from benchmark.reference.gan import WGANGP, draws

MAN = manifest.load()
CELL = "gan64_train"


def test_gan_cell_is_correct(run_cell):
    out = run_cell(CELL)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_bf16_control_fails_gan_training(tiny, seed):
    w = manifest.cell(MAN, CELL)
    tr = manifest.traffic(w["traffic"])
    d = drivers.load(tr["driver"])(manifest.config(MAN, w["config"]), tr,
                                   seed, "cpu", ROOT)
    d.setup()
    d.window(0.0)
    d.release()
    terms, grads, afters = d.reference()
    ct, cg, ca = d.reference("bfloat16")
    numbers = compare(ct, cg[0], d.states[:-1], ca, terms, grads, afters)
    limits = manifest.limits(CELL)["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def _fault(monkeypatch, kind):
    from pyqg_generative_torch.models import cgan_regression as gan
    real_step, real_penalty = gan.GanTrainer.step, gan.gradient_penalty
    if kind == "no_double_backward":
        monkeypatch.setattr(gan, "gradient_penalty",
                            lambda *a: real_penalty(*a).detach())
    elif kind == "half_batch":
        monkeypatch.setattr(gan.GanTrainer, "step",
                            lambda self, i, idx: real_step(
                                self, i, idx[:len(idx) // 2]))
    elif kind == "no_generator":  # its batches run as critic-only ones
        monkeypatch.setattr(gan.GanTrainer, "step",
                            lambda self, i, idx: real_step(
                                self, i + (i % 5 == 0), idx))
    elif kind == "critic_count_stays":
        def step(self, i, idx):
            count = self.opt["D"]["count"]
            out = real_step(self, i, idx)
            self.opt["D"]["count"] = count
            return out
        monkeypatch.setattr(gan.GanTrainer, "step", step)
    elif kind == "generator_count_every_batch":
        def step(self, i, idx):
            out = real_step(self, i, idx)
            self.opt["G"]["count"] += i % 5 != 0
            return out
        monkeypatch.setattr(gan.GanTrainer, "step", step)
    else:  # from the second step on, as a replay that did not write them
        # back, the moments computed but not left in the state (the first
        # step's, which `grad_gap` reads, stay)
        def step(self, i, idx):
            kept = {net: {part: {k: v.clone() for k, v in s[part].items()}
                          for part in ("mu", "nu")}
                    for net, s in self.opt.items()}
            first = self.opt["D"]["count"] == 0
            out = real_step(self, i, idx)
            if first:
                return out
            with torch.no_grad():
                for net, parts in kept.items():
                    for part, leaves in parts.items():
                        for k, v in leaves.items():
                            self.opt[net][part][k].copy_(v)
            return out
        monkeypatch.setattr(gan.GanTrainer, "step", step)


@pytest.mark.parametrize("kind", [
    "no_double_backward", "half_batch", "no_generator",
    "critic_count_stays", "generator_count_every_batch",
    "moments_not_written_back"])
def test_a_broken_gan_step_is_not_correct(run_cell, monkeypatch, kind):
    _fault(monkeypatch, kind)
    out = run_cell(CELL)
    assert not out["correct"], out["checks"]


# ---------------------------------------------------------------- readers
def _trace(device, window=(0.0, 1000.0)):
    return tracing.Trace(device=device, host=[(tracing.MARK,) + window],
                         window=window)


def _ctx(trace=None, work=None, counters=None):
    return SimpleNamespace(
        trace=trace, work=work or {}, counters=counters or {},
        config=manifest.config(MAN, "r4_eddy_gan_64_op1_s0"),
        traffic={}, yardstick=yardstick)


REPLAYED = {
    "graphed window": ({"eager_steps": 0, "captured_steps": 0,
                        "replayed_steps": 700, "generator_steps": 140},
                       100.0),
    "eager steps": ({"eager_steps": 300, "captured_steps": 0,
                     "replayed_steps": 0}, 0.0),
    "two eager, two captured, the rest replayed": (
        {"eager_steps": 2, "captured_steps": 2, "replayed_steps": 8}, 80.0),
    "no training counters": ({}, None),
}


@pytest.mark.parametrize("case", sorted(REPLAYED))
def test_replayed_share_reader(case):
    counters, want = REPLAYED[case]
    got = manifest.reader("gan_train.replayed_share")(_ctx(counters=counters))
    assert got == want


def test_mfu_reader_weights_the_generator_batches():
    """700 batches of which 140 updated the generator: the period's
    operations a sample at 64^2 times the untraced rate over 67 TFLOP/s;
    with no generator batch, the critic-only step's; without the counter
    (a program that lacks it) or the untraced rate, nothing."""
    read = manifest.reader("gan_train.mfu")
    work = {"untraced_rate": 800.0, "window_batches": 700}
    hidden = (128, 64, 32, 32, 32, 32, 32)
    got = read(_ctx(work=work, counters={"generator_steps": 140}))
    want = 100 * gan_flops.gan_train_flops_per_sample(hidden, 64, 0.2) \
        * 800.0 / 67e12
    assert got == pytest.approx(want, rel=1e-12)
    assert 12.0 < got < 13.0  # 10.37 GFLOP a sample at 800 samples/s
    critic = read(_ctx(work=work, counters={"generator_steps": 0}))
    assert critic == pytest.approx(
        100 * gan_flops.gan_train_flops_per_sample(hidden, 64, 0.0)
        * 800.0 / 67e12, rel=1e-12)
    assert read(_ctx(work=work, counters={})) is None
    assert read(_ctx(work={"window_batches": 700},
                     counters={"generator_steps": 140})) is None


def test_kernels_and_idle_readers():
    """5 traced batches: 3 kernels each and a copy and a fill that are not
    kernels; the device is busy 750 of the window's 1000 us."""
    device = []
    for b in range(5):
        t = 200.0 * b
        device += [("sm90_gemm", t, t + 60), ("im2col", t + 60, t + 100),
                   ("elementwise", t + 100, t + 120),
                   ("Memcpy DtoD", t + 120, t + 140),
                   ("Memset", t + 150, t + 160)]
    trace = _trace(device)
    work = {"batches": 5, "samples": 320}
    kernels = manifest.reader("gan_train.kernels_per_batch")
    idle = manifest.reader("gan_train.device_idle")
    assert kernels(_ctx(trace, work)) == 3.0
    assert idle(_ctx(trace, work)) == pytest.approx(100 * (1 - 750 / 1000))
    assert kernels(_ctx(None, work)) is None
    assert idle(_ctx(None, work)) is None


# ------------------------------------------------------------- operations
def test_flops_match_the_flop_counter_over_a_period():
    """The reference's period (a generator batch, then four critic-only
    ones) at 16^2 with the paper's widths, batch 2, counted by
    `FlopCounterMode` (its convolutions, their backward and the penalty's
    double backward as autograd runs them): `gan_train_flops_per_sample`
    at a share of 1/5 within 1%."""
    from torch.utils.flop_counter import FlopCounterMode
    nx, b = 16, 2
    cfg = shrink_config(manifest.config(MAN, "r4_eddy_gan_64_op1_s0"))
    hidden = cfg["model_args"]["hidden_channels"]
    gen = torch.Generator().manual_seed(0)
    ref = WGANGP(inputs.andrew_variables(gen, 4, 2, hidden),
                 critic_variables(gen, nx), "cpu", 2e-4, 200, 335)
    x, y = (torch.randn(b, 2, nx, nx, generator=gen) for _ in range(2))
    with precision("float32", cudnn=False), \
            FlopCounterMode(display=False) as counter:
        for i in range(5):
            ref.step(x, y, draws(gen, b, nx), i % 5 == 0)
    want = 5 * b * gan_flops.gan_train_flops_per_sample(hidden, nx, 0.2)
    assert counter.get_total_flops() == pytest.approx(want, rel=0.01)


def test_flops_of_the_cell():
    """At 64^2 with the paper's widths: the critic-only step, the
    generator batch and the period's mean a sample."""
    hidden = (128, 64, 32, 32, 32, 32, 32)
    critic = gan_flops.critic_layer_flops(64)
    assert critic == [2.0 * 16 * 6 * 64 * 32 * 32,
                      2.0 * 16 * 64 * 128 * 16 * 16,
                      2.0 * 16 * 128 * 256 * 8 * 8,
                      2.0 * 16 * 256 * 512 * 4 * 4,
                      2.0 * 16 * 512]
    f = [gan_flops.gan_train_flops_per_sample(hidden, 64, s) / 1e9
         for s in (0.0, 0.2, 1.0)]
    assert np.allclose(f, [7.639, 10.371, 21.299], atol=1e-3)


def test_shrunk_traffic_crosses_an_epoch():
    """At the CPU's size (40 samples, batch 8: 5 batches an epoch) the
    11 checked steps take both branches in two epochs and a third's
    first batch."""
    tr = shrink_traffic(manifest.traffic("gan_train_b64_21414"))
    per_epoch = -(-tr["samples"] // tr["batch_size"])
    branches = [s % per_epoch % 5 == 0 for s in range(tr["check_steps"])]
    assert per_epoch == 5 and branches.count(True) == 3
