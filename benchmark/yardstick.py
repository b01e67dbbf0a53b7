"""The benchmark's arithmetic: the card's peaks, operations and bytes from
shapes, interval unions and shares.

Copied from the repo's measurement scripts and rewritten here, where a
change to the program cannot move the yardstick:

* `closure_flops_per_member_step` is `bench_torch.py::_conv_flops` and
  `model_flops_per_member_step`, read off the configuration's widths
  rather than a weight tree;
* `union_us` is `chip_smoke.py::_union_us`; `busy_share` is
  `chip_smoke.py::traced_busy`'s share with its denominator repaired: the
  traced window's wall span, from the host's start mark to its end mark,
  and not the span from the first kernel's start to the last kernel's end,
  which leaves out the idle time at the window's edges;
* `least_seconds` is the bound of `chip_smoke.py::kernel_row`.

Counting rules: a convolution of kernel K x K from cin to cout channels at
H x W costs 2 K^2 cin cout H W operations (a multiply and an add per tap);
a kernel's bytes count each input, weight and output byte once, whatever
the kernel reads again.
"""
from __future__ import annotations

from typing import Iterable, Sequence

# One H100 SXM (NVIDIA data sheet, 700 W, dense): float32 outside the
# tensor cores, bf16 on them, HBM3.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

ANDREW_KERNELS = (5, 5, 3, 3, 3, 3, 3, 3)


def andrew_layers(n_in: int, n_out: int, hidden: Sequence[int],
                  kernels: Sequence[int] = ANDREW_KERNELS) -> list:
    """(K, cin, cout) of each convolution of an AndrewCNN."""
    chans = [n_in] + list(hidden) + [n_out]
    return [(k, chans[i], chans[i + 1]) for i, k in enumerate(kernels)]


def layers_flops(layers, h: int, w: int) -> float:
    """Operations of one image through convolutions (K, cin, cout)."""
    return float(sum(2 * k * k * ci * co for k, ci, co in layers) * h * w)


def closure_flops_per_member_step(hidden: Sequence[int], nx: int,
                                  n_in: int = 4, n_out: int = 2) -> float:
    """The closure's CNN in one member-step: every convolution of the
    AndrewCNN at nx^2 (the solver's FFTs excluded), as
    `bench_torch.model_flops_per_member_step` counts a generator."""
    return layers_flops(andrew_layers(n_in, n_out, hidden), nx, nx)


def k1_chain_cost(hidden: Sequence[int], nx: int, members: int,
                  n_out: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one K1 call: Conv_1..Conv_n of the AndrewCNN
    for `members` images at nx^2, float32. Bytes: the chain's input (the
    first hidden layer's channels), its output, and its weights and biases,
    each once."""
    layers = andrew_layers(4, n_out, hidden)[1:]
    flops = layers_flops(layers, nx, nx) * members
    weights = sum(k * k * ci * co + co for k, ci, co in layers)
    nbytes = 4.0 * (members * nx * nx * (hidden[0] + n_out) + weights)
    return flops, nbytes


def vae_train_flops_per_sample(hidden: Sequence[int], nx: int,
                               n_latent: int = 2) -> float:
    """Operations of one sample of a sigma-VAE training step. Encoder:
    (x, y), 4 channels -> (mu, logvar), 2 n_latent; decoder: (x, z), 2 +
    n_latent -> 2. Rule: a forward F, a backward 2F (the input's gradient
    and the weights'), except the encoder's first convolution, whose input
    is data and needs no gradient (F for its weights alone). The loss, the
    BatchNorms and Adam are elementwise and not counted."""
    enc = andrew_layers(4, 2 * n_latent, hidden)
    dec = andrew_layers(2 + n_latent, 2, hidden)
    f_enc, f_dec = layers_flops(enc, nx, nx), layers_flops(dec, nx, nx)
    f_enc0 = layers_flops(enc[:1], nx, nx)
    return 3.0 * (f_enc + f_dec) - f_enc0


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over
    peak rate and bytes over peak bandwidth, and which of the two."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def union_us(intervals: Iterable[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    spans = sorted(intervals)
    if not spans:
        return 0.0
    total, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            total, lo, hi = total + hi - lo, s, e
        else:
            hi = max(hi, e)
    return total + hi - lo


def clip(intervals, lo: float, hi: float) -> list:
    """The parts of (start, end) intervals that lie inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_share(intervals, window: tuple[float, float]) -> float:
    """The union of the kernel intervals inside the window over the
    window's wall span (host start mark to host end mark)."""
    lo, hi = window
    return union_us(clip(intervals, lo, hi)) / (hi - lo)


def idle_gaps(intervals, window: tuple[float, float]) -> list:
    """(start, end) of each stretch of the window in which no kernel ran,
    longest first."""
    lo, hi = window
    gaps, t = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])
