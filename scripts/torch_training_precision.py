"""Why the port trains with cuDNN off: the float32 precision of a training
step's convolutions on one NVIDIA GPU, cuDNN against PyTorch's own path.

1. Single convolutions of the closures' shapes (5x5 4 -> 32 at 4 x 32^2,
   4 -> 128 and 128 -> 64 at 8 x 64^2, 3x3 32 -> 32 at 8 x 64^2): the
   forward, the input gradient and the weight gradient on the card in
   float32, against the same in float64 on the CPU, as relative RMS, with
   cuDNN on (its deterministic algorithms, `device.exact_fp32`) and off
   (im2col and cuBLAS GEMMs).
2. One GAN batch step (critic and generator, i = 0) on seeded weights at
   32^2 and on the committed r4_eddy_gan_64_op1_s0 at 64^2, on random
   unit-variance batches: each gradient tensor's relative RMS against the
   CPU's float64 step, with cuDNN on and off. (A bias whose gradient
   vanishes in exact arithmetic shows as ~1e8 either way; `chip_smoke.py`
   phase 11 holds those against their weight's.)
3. A GAN batch step at 64 x 64^2 on the committed weights, timed by the
   host clock over 10 batches (one generator update in five), with cuDNN
   on, off, on.

Run from the repository root on a machine with a GPU:
    python3 scripts/torch_training_precision.py
"""
import pathlib
import sys
import time
import subprocess
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pyqg_generative_torch.device import exact_fp32  # noqa: E402
from pyqg_generative_torch.ml.train import named_params  # noqa: E402
from pyqg_generative_torch.ml.weights import params_from_jax, \
    seeded_variables  # noqa: E402
from pyqg_generative_torch.models import CGANRegression, \
    load_model  # noqa: E402
from pyqg_generative_torch.models import cgan_regression as gan  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@contextmanager
def cudnn(enabled: bool):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def single_convs():
    rng = np.random.default_rng(0)
    for B, ci, co, k, n in ((4, 4, 32, 5, 32), (8, 4, 128, 5, 64),
                            (8, 128, 64, 5, 64), (8, 32, 32, 3, 64)):
        x64 = torch.tensor(rng.standard_normal(
            (B, ci, n + k - 1, n + k - 1)), requires_grad=True)
        w64 = torch.tensor(rng.standard_normal((co, ci, k, k))
                           / np.sqrt(ci * k * k), requires_grad=True)
        gy = torch.tensor(rng.standard_normal((B, co, n, n)))
        y64 = F.conv2d(x64, w64)
        gx64, gw64 = torch.autograd.grad(y64, (x64, w64), gy)
        for enabled in (True, False):
            with cudnn(enabled), exact_fp32():
                x = x64.detach().float().cuda().requires_grad_()
                w = w64.detach().float().cuda().requires_grad_()
                y = F.conv2d(x, w)
                gx, gw = torch.autograd.grad(y, (x, w), gy.float().cuda())
            print(f"conv {ci} -> {co}, {k}x{k}, {B} x {n}^2, cudnn "
                  f"{'on' if enabled else 'off'}: forward {rel(y, y64):.2e}, "
                  f"input gradient {rel(gx, gx64):.2e}, weight gradient "
                  f"{rel(gw, gw64):.2e}", flush=True)


def seeded(dev):
    m = CGANRegression(nx=32, folder="missing", device=dev,
                       hidden_channels=(32, 16))
    for module, seed in ((m.G, 1), (m.D, 2)):
        module.load_state_dict(params_from_jax(seeded_variables(module,
                                                                seed)))
    return m


def committed(dev):
    return load_model(str(ROOT / "trained_models" / "r4_eddy_gan_64_op1_s0"),
                      device=dev)


@contextmanager
def step_cudnn(enabled: bool):
    """A GAN batch step runs under `device.exact_fp32_training` (cuDNN
    off); with `enabled`, under `exact_fp32` (cuDNN on) instead."""
    orig = gan.exact_fp32_training
    gan.exact_fp32_training = exact_fp32 if enabled else orig
    try:
        yield
    finally:
        gan.exact_fp32_training = orig


def step_grads(make, dev, dtype, arrays, enabled=False):
    """One GAN batch step's gradients by parameter name."""
    m = make(dev)
    m.G.to(dtype)
    m.D.to(dtype)
    t = [torch.as_tensor(a, device=dev, dtype=torch.bool if a.dtype == bool
                         else dtype) for a in arrays]
    txG, txD = gan.gan_optimizers(2e-4, 2, 3)
    opt = {"G": txG.init(named_params(m.G)),
           "D": txD.init(named_params(m.D))}
    grads = {}
    with step_cudnn(enabled):
        gan.make_gan_batch_step(m, txG, txD)(opt, tuple(t[:3]), 0,
                                             tuple(t[3:]), grads)
    return {f"{k}.{n}": v for k in ("D", "G") for n, v in grads[k].items()}


def gan_steps():
    for name, make, nx, B in (("seeded 32^2", seeded, 32, 4),
                              ("r4_eddy_gan_64_op1_s0", committed, 64, 8)):
        rng = np.random.default_rng(5)
        arrays = [rng.standard_normal((B, nx, nx, 2)) for _ in range(2)] \
            + [np.zeros((B, nx, nx, 2))] \
            + [rng.standard_normal((B, nx, nx, 2)) for _ in range(2)] \
            + [rng.random((B, 1, 1, 1)), np.asarray(True)]
        ref = step_grads(make, "cpu", torch.float64, arrays)
        for enabled in (True, False):
            out = step_grads(make, "cuda", torch.float32, arrays, enabled)
            errs = {k: rel(out[k], g) for k, g in ref.items()}
            worst = sorted(((v, k) for k, v in errs.items() if v < 1),
                           reverse=True)[:4]
            print(f"GAN step, {name}, cudnn {'on' if enabled else 'off'}: "
                  "largest relative RMS of the gradients (those that do "
                  "not vanish): " + ", ".join(f"{k} {v:.2e}"
                                              for v, k in worst), flush=True)


def timing(smi):
    m = committed("cuda")
    x = torch.randn((64, 64, 64, 2), device="cuda")
    batch = (x, torch.randn_like(x), torch.zeros_like(x))
    g = torch.Generator(device="cuda").manual_seed(0)
    txG, txD = gan.gan_optimizers(2e-4, 2, 10)
    opt = {"G": txG.init(named_params(m.G)),
           "D": txD.init(named_params(m.D))}
    step = gan.make_gan_batch_step(m, txG, txD)
    for enabled in (True, False, True):
        with step_cudnn(enabled):
            for j in range(5):
                step(opt, batch, j, gan.gan_draws(g, x, 2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for j in range(10):
                step(opt, batch, j % 5, gan.gan_draws(g, x, 2))
            torch.cuda.synchronize()
        print(f"GAN batch step at 64 x 64^2, cudnn "
              f"{'on' if enabled else 'off'}: "
              f"{(time.perf_counter() - t0) / 10 * 1e3:.2f} ms on {smi}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    single_convs()
    gan_steps()
    timing(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
