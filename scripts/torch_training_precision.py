"""The float32 precision of a training step's convolutions on one NVIDIA GPU:
cuDNN, PyTorch's own path, and the split route that trains the port's
AndrewCNNs (`ml/train_conv.py`).

1. Single convolutions: the closures' shapes (5x5 4 -> 32 at 4 x 32^2,
   4 -> 128 and 128 -> 64 at 8 x 64^2, 3x3 32 -> 32 at 8 x 64^2), then the
   sigma-VAE's 16 convs at 8 x 64^2 (encoder and decoder, Conv_0..Conv_7).
   The forward, the input gradient and the weight and bias gradients on
   the card in float32, against the same in float64 on the CPU, as
   relative RMS, with cuDNN on (its deterministic algorithms,
   `device.exact_fp32`), off (im2col and cuBLAS GEMMs) and on the split
   route (`ml.train_conv.split_conv2d` under `exact_fp32_training`: cuDNN's
   input gradient where `train_conv.cudnn_input_grad` allows, PyTorch's
   forward, weight and bias gradients). The last line is the route's worst
   input gradient in cuDNN and the worst cuDNN forward, against the 1e-6
   above which a pass keeps PyTorch's path.
2. The sigma-VAE's distinct conv shapes at 64 x 64^2 (the benchmark's
   batch), each pass timed by CUDA events: cuDNN's forward and input
   gradient on NCHW and on channels-last tensors, PyTorch's own forward,
   input gradient and weight gradient on NCHW, and its weight gradient from
   channels-last tensors.
3. One sigma-VAE step at 64 x 64^2 from fresh weights (two seeds): each
   gradient's distance from the same step in float64 on the card, over the
   larger of its norm and the median gradient's, the worst and the median
   (leaves under a thousandth of the median left out, as the benchmark's
   gate does), with PyTorch's own convs, on the split route, and on the
   route with each forward's value taken from cuDNN.
4. One GAN batch step (critic and generator, i = 0) on seeded weights at
   32^2 and on the committed r4_eddy_gan_64_op1_s0 at 64^2, on random
   unit-variance batches: each gradient tensor's relative RMS against the
   CPU's float64 step, with cuDNN on throughout and under
   `exact_fp32_training` (the critic's convs in PyTorch's own path, the
   generator's on the split route). (A bias whose gradient vanishes in
   exact arithmetic shows as ~1e8 either way; `chip_smoke.py` phase 11
   holds those against their weight's.)
5. A GAN batch step at 64 x 64^2 on the committed weights, timed by the
   host clock over 10 batches (one generator update in five), with cuDNN
   on throughout, under `exact_fp32_training`, and on again.

Run from the repository root on a machine with a GPU:
    python3 scripts/torch_training_precision.py
"""
import copy
import pathlib
import sys
import time
import subprocess
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pyqg_generative_torch.device import exact_fp32, \
    exact_fp32_training  # noqa: E402
from pyqg_generative_torch.ml import nets  # noqa: E402
from pyqg_generative_torch.ml.train_conv import cudnn_input_grad, \
    split_conv2d  # noqa: E402
from pyqg_generative_torch.models import CVAERegression  # noqa: E402
from pyqg_generative_torch.models import cvae_regression as cvae  # noqa: E402
from pyqg_generative_torch.ml.train import named_params  # noqa: E402
from pyqg_generative_torch.ml.weights import params_from_jax, \
    seeded_variables  # noqa: E402
from pyqg_generative_torch.models import CGANRegression, \
    load_model  # noqa: E402
from pyqg_generative_torch.models import cgan_regression as gan  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEV = "cuda"


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


def vae_convs():
    """The sigma-VAE's 16 convs: (name, c_in, c_out, k, input needs a
    gradient); the encoder's Conv_0 reads the data."""
    out = []
    for part, net in (("encoder", nets.AndrewCNN(4, 4)),
                      ("decoder", nets.AndrewCNN(4, 2))):
        for i in range(net.n_layers):
            co, ci, k, _ = getattr(net, f"Conv_{i}").weight.shape
            out.append((f"{part}.Conv_{i}", ci, co, k,
                        not (part == "encoder" and i == 0)))
    return out


def conv_passes(x, w, b, gy, route):
    """(y, gx, gw, gb) of a valid conv on the route "cudnn", "own" or
    "split", in float32 on the card."""
    x = x.detach().float().to(DEV).requires_grad_(x.requires_grad)
    w = w.detach().float().to(DEV).requires_grad_()
    b = b.detach().float().to(DEV).requires_grad_()
    if route == "split":
        with exact_fp32_training():
            y = split_conv2d(x, w, b)
    else:
        with cudnn(route == "cudnn"), exact_fp32():
            y = F.conv2d(x, w, b)
    wrt = (x, w, b) if x.requires_grad else (w, b)
    with cudnn(route == "cudnn"), exact_fp32():
        g = torch.autograd.grad(y, wrt, gy.float().to(DEV))
    return (y,) + ((None,) if len(g) == 2 else ()) + tuple(g)


def conv_passes_ref(x, w, b, gy):
    """(y, gx, gw, gb) in float64 on the CPU."""
    y = F.conv2d(x, w, b)
    wrt = (x, w, b) if x.requires_grad else (w, b)
    g = torch.autograd.grad(y, wrt, gy)
    return (y,) + ((None,) if len(g) == 2 else ()) + tuple(g)


def single_convs():
    rng = np.random.default_rng(0)
    shapes = [(f"{ci} -> {co}", B, ci, co, k, n, True)
              for B, ci, co, k, n in ((4, 4, 32, 5, 32), (8, 4, 128, 5, 64),
                                      (8, 128, 64, 5, 64),
                                      (8, 32, 32, 3, 64))]
    shapes += [(f"sigma-VAE {name}, {ci} -> {co}", 8, ci, co, k, 64, dx)
               for name, ci, co, k, dx in vae_convs()]
    worst = {}
    for label, B, ci, co, k, n, dx in shapes:
        x64 = torch.tensor(rng.standard_normal(
            (B, ci, n + k - 1, n + k - 1)), requires_grad=dx)
        w64 = torch.tensor(rng.standard_normal((co, ci, k, k))
                           / np.sqrt(ci * k * k), requires_grad=True)
        b64 = torch.tensor(rng.standard_normal(co) * 0.1,
                           requires_grad=True)
        gy = torch.tensor(rng.standard_normal((B, co, n, n)))
        ref = conv_passes_ref(x64, w64, b64, gy)
        for route in ("cudnn", "own", "split"):
            got = conv_passes(x64, w64, b64, gy, route)
            errs = [None if g is None else rel(g, r)
                    for g, r in zip(got, ref)]
            for what, e, on in (
                    ("cuDNN forward", errs[0], route == "cudnn"),
                    ("route's cuDNN input gradient", errs[1],
                     route == "split" and cudnn_input_grad(k, co))):
                if on and e is not None and e > worst.get(what, (0,))[0]:
                    worst[what] = (e, label)
            print(f"conv {label}, {k}x{k}, {B} x {n}^2, {route}: "
                  + ", ".join(f"{what} {'-' if e is None else f'{e:.2e}'}"
                              for what, e in zip(
                                  ("forward", "input gradient",
                                   "weight gradient", "bias gradient"),
                                  errs)), flush=True)
    print("worst: " + ", ".join(f"{what} {e:.2e} ({label})" for what, (
        e, label) in worst.items()) + "; a pass above 1e-6 keeps PyTorch's "
          "path", flush=True)


def cuda_ms(fn, n=20):
    """ms a call by CUDA events over n calls, after 3."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def pass_times(smi, B=64):
    """Each pass of the sigma-VAE's distinct conv shapes at B x 64^2."""
    seen = set()
    for name, ci, co, k, _ in vae_convs():
        if (ci, co, k) in seen:
            continue
        seen.add((ci, co, k))
        x = torch.randn((B, ci, 64 + k - 1, 64 + k - 1), device=DEV)
        w = torch.randn((co, ci, k, k), device=DEV) / (ci * k * k) ** .5
        gy = torch.randn((B, co, 64, 64), device=DEV)
        row = {}
        for layout in ("nchw", "nhwc"):
            fmt = torch.channels_last if layout == "nhwc" \
                else torch.contiguous_format
            xl, wl, gl = (t.contiguous(memory_format=fmt)
                          for t in (x, w, gy))

            def back(mask):
                return torch.ops.aten.convolution_backward(
                    gl, xl, wl, [co], [1, 1], [0, 0], [1, 1], False,
                    [0, 0], 1, mask)
            for on in (True, False):
                if on is False and layout == "nhwc":
                    row["own wgrad nhwc"] = cuda_ms(
                        lambda: back([False, True, True]))
                    continue
                tag = "cudnn" if on else "own"
                with cudnn(on), exact_fp32():
                    row[f"{tag} fwd {layout}"] = cuda_ms(
                        lambda: F.conv2d(xl, wl))
                    row[f"{tag} dgrad {layout}"] = cuda_ms(
                        lambda: back([True, False, False]))
                    if not on:
                        row[f"own wgrad {layout}"] = cuda_ms(
                            lambda: back([False, True, True]))
        print(f"{ci} -> {co}, {k}x{k}, {B} x 64^2 (first: {name}), ms a "
              f"call on {smi}: " + ", ".join(f"{key} {v:.3f}"
                                             for key, v in row.items()),
              flush=True)


def cudnn_forward(x, w, b):
    """The split route with the forward's value taken from cuDNN: the
    route's gradients, cuDNN's output."""
    y = split_conv2d(x, w, b)
    with cudnn(True), exact_fp32(), torch.no_grad():
        yc = F.conv2d(x, w, b)
    return y + (yc - y).detach()


def vae_step_grads(net, data, eps, dtype, conv):
    """One sigma-VAE step's gradients by name, its AndrewCNNs' training
    convs through `conv`, under `exact_fp32_training`."""
    enc, dec = (copy.deepcopy(m).to(dtype) for m in (net.encoder,
                                                     net.decoder))
    step_net = copy.copy(net)
    step_net.encoder, step_net.decoder = enc, dec
    orig = nets.split_conv2d
    nets.split_conv2d = conv
    try:
        params = cvae.vae_params(step_net)
        with exact_fp32_training():
            loss, _ = cvae.make_vae_loss(step_net)(
                *(d.to(dtype) for d in data), eps.to(dtype), True)
            grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        nets.split_conv2d = orig
    return dict(zip(params, grads))


def vae_steps(B=64, nx=64):
    for seed in (3, 4):
        net = CVAERegression(folder=str(ROOT / "build" / "missing"),
                             device=DEV)
        g = torch.Generator(device=DEV).manual_seed(seed)
        for m in (net.encoder, net.decoder):
            nets.init_weights(m, g)
        data = [torch.randn((B, nx, nx, 2), device=DEV, generator=g)
                for _ in range(2)]
        data.append(torch.zeros_like(data[1]))
        eps = cvae.vae_eps(g, net, data[0])
        ref = vae_step_grads(net, data, eps, torch.float64, F.conv2d)
        norm = {k: float(v.norm()) for k, v in ref.items()}
        median = float(np.median(list(norm.values())))
        moving = [k for k in ref if norm[k] >= 1e-3 * median]
        for name, conv in (("PyTorch's own convs", F.conv2d),
                           ("split route", split_conv2d),
                           ("split route, cuDNN forwards", cudnn_forward)):
            got = vae_step_grads(net, data, eps, torch.float32, conv)
            dist = {k: float((got[k].double() - ref[k]).norm())
                    / max(norm[k], median) for k in moving}
            k_worst = max(dist, key=dist.get)
            print(f"sigma-VAE step, {B} x {nx}^2, seed {seed}, {name}: "
                  f"distance from float64, worst {dist[k_worst]:.3e} "
                  f"({k_worst}), median {np.median(list(dist.values())):.3e}",
                  flush=True)


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
    off but for the generator's split route); with `enabled`, under
    `exact_fp32` with the generator's convs in plain `F.conv2d` (cuDNN
    throughout) instead."""
    orig = gan.exact_fp32_training, nets.split_conv2d
    if enabled:
        gan.exact_fp32_training, nets.split_conv2d = exact_fp32, F.conv2d
    try:
        yield
    finally:
        gan.exact_fp32_training, nets.split_conv2d = orig


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
        gan.make_gan_batch_step(m, txG, txD)(opt, tuple(t[:3]), True,
                                             tuple(t[3:]), grads=grads)
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
            print(f"GAN step, {name}, "
                  f"{'cudnn on' if enabled else 'exact_fp32_training'}: "
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
                step(opt, batch, j == 0, gan.gan_draws(g, x, 2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for j in range(10):
                step(opt, batch, j % 5 == 0, gan.gan_draws(g, x, 2))
            torch.cuda.synchronize()
        print(f"GAN batch step at 64 x 64^2, "
              f"{'cudnn on' if enabled else 'exact_fp32_training'}: "
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
    pass_times(smi)
    vae_steps()
    gan_steps()
    timing(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
