"""A training convolution split by pass: cuDNN's input gradient where it
keeps float32's precision, PyTorch's own forward, weight and bias
gradients.

`device.exact_fp32_training` turns cuDNN off for a whole training step,
because cuDNN's deterministic weight-gradient algorithms of the closures'
5x5 convolutions miss float64 by up to 2.3e-3 in relative RMS on an H100.
PyTorch's own path loops over the batch, with an im2col or col2im copy and
a small GEMM for each sample, and its input gradient (a GEMM and a col2im
a sample) costs the most: 48.7 of the sigma-VAE's 111 ms a batch of conv
passes at 64 x 64^2, against 7.5 in cuDNN. `SplitConv2d` runs that pass in
cuDNN (float32, TF32 off, deterministic algorithms, no autotuning, so a
step repeats bit for bit) where `cudnn_input_grad` allows, and every other
pass with cuDNN off: its forward and its weight and bias gradients are
bitwise what a step under `exact_fp32_training` computes for the same
input and incoming gradient.

Measured on an H100 (`scripts/torch_training_precision.py`, float32
against float64, relative RMS, the sigma-VAE's convs at 8 and 64 x 64^2):

    conv, k          input gradient: cuDNN (algorithm)  own      route
    4 -> 128, 5x5    9.9e-7 (implicit GEMM)             2.3e-7   own
    128 -> 64, 5x5   2.6e-7 (FFT)                       1.7e-7   cuDNN
    64 -> 32, 3x3    2.3e-7 to 3.0e-7 (FFT, GEMM at 8)  1.2e-7   cuDNN
    32 -> 32, 3x3    2.3e-7 (FFT)                       1.2e-7   cuDNN
    32 -> 4, 3x3     1.1e-7 (implicit GEMM)             7.9e-8   cuDNN
    32 -> 2, 3x3     8.6e-8 (implicit GEMM)             7.4e-8   cuDNN

cuDNN's input gradient at 4 -> 128 reads within 2% of the 1e-6 that keeps
a pass on PyTorch's path (and is no faster, 2.4 against 2.2 ms), so the
rule takes cuDNN only where the pass sums over c_out * k^2 <= 1600 terms.
cuDNN's forward reads 1.0 to 2.8 times PyTorch's own (1.8e-7 to 1.0e-6),
and a sigma-VAE step with its forwards in cuDNN reads 2.6 to 2.9 times
PyTorch's distance from float64 in its worst leaf (1.86e-3 against
6.5e-4), enough to fail the benchmark's gate, while the input gradient in
cuDNN leaves that distance as it was (6.49e-4): the forward stays on
PyTorch's path.

`nets.CircularConv2d`, the AndrewCNN's conv, routes its training calls
through it (train mode, gradients enabled, the weight requiring one);
every other call is `nn.Conv2d`'s own.
Each backward counts `train_conv.split_backward` and wraps the weight
gradient in the span `train.conv_wgrad` (`utils.profiling`); on a CUDA
tensor the backward runs on the autograd engine's thread, where that span
is a root. The backward is `once_differentiable`: a double backward
through it raises. On a CPU tensor the cuDNN settings do nothing, so the
route computes PyTorch's own convolution, its backward in two calls.
"""
from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import count, span

__all__ = ["SplitConv2d", "split_conv2d", "cudnn_input_grad"]

# the longest sum of an input gradient's output element that the card has
# shown cuDNN to keep within 1e-6 of float64 (128 -> 64, 5x5: 64 * 25)
CUDNN_INPUT_GRAD_TERMS = 1600


def cudnn_input_grad(kernel: int, c_out: int) -> bool:
    """Whether a stride-1 `kernel` x `kernel` conv to `c_out` channels
    takes its input gradient from cuDNN (the module's table)."""
    return c_out * kernel * kernel <= CUDNN_INPUT_GRAD_TERMS


@contextmanager
def _cudnn(enabled: bool):
    """cuDNN on (float32, TF32 off, deterministic, no autotuning) or off,
    the previous settings restored on exit."""
    b = torch.backends.cudnn
    prev = (b.enabled, b.benchmark, b.deterministic, b.allow_tf32)
    b.enabled, b.benchmark, b.deterministic, b.allow_tf32 = \
        enabled, False, True, False
    try:
        yield
    finally:
        b.enabled, b.benchmark, b.deterministic, b.allow_tf32 = prev


@lru_cache(maxsize=None)
def _load_cudnn(device: torch.device) -> None:
    """Load cuDNN from the caller's thread, once a device. A CUDA backward
    runs on the autograd engine's own thread, and cuDNN's first call there
    made a sigma-VAE run's first step take 3.0-3.2 s on an H100's host,
    against 0.9-1.3 s without cuDNN; loaded here first it takes 0.4-0.5 s
    and the first step 0.9-1.5 s."""
    with _cudnn(True):
        F.conv2d(torch.zeros((1, 1, 3, 3), device=device),
                 torch.zeros((1, 1, 3, 3), device=device))


class SplitConv2d(torch.autograd.Function):
    """A stride-1 "valid" conv2d of an NCHW input (padded by the caller)
    with an OIHW weight and an optional bias: the input gradient in cuDNN
    where `cudnn_input_grad` allows, every other pass on PyTorch's own
    path."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        c_out, _, k, _ = weight.shape
        if x.is_cuda and ctx.needs_input_grad[0] \
                and cudnn_input_grad(k, c_out):
            _load_cudnn(x.device)
        with _cudnn(False):
            y = F.conv2d(x, weight, bias)
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        count("train_conv.split_backward")
        bias_sizes = [weight.shape[0]] if ctx.has_bias else None

        def grads(mask):
            return torch.ops.aten.convolution_backward(
                gy, x, weight, bias_sizes, [1, 1], [0, 0], [1, 1], False,
                [0, 0], 1, mask)

        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            c_out, _, k, _ = weight.shape
            with _cudnn(cudnn_input_grad(k, c_out)):
                gx = grads([True, False, False])[0]
        need_w = ctx.needs_input_grad[1]
        need_b = ctx.has_bias and ctx.needs_input_grad[2]
        if need_w or need_b:
            with span("train.conv_wgrad"), _cudnn(False):
                _, gw, gb = grads([False, need_w, need_b])
        return gx, gw, gb


def split_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """`SplitConv2d` on an NCHW input already padded for a valid conv."""
    return SplitConv2d.apply(x, weight, bias)
