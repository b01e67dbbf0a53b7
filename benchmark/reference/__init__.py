"""The plain reference that decides `correct`: plain PyTorch in float32,
with no kernel, graph, folding or batching trick of the program.

* `qg.py`: the two-layer quasi-geostrophic model, its JAMES initial
  condition, the AR1 noise sampler and the spectral diagnostics;
* `cnn.py`: the AndrewCNN with its BatchNorms, read from flax msgpack
  weights with the `msgpack` package, in eval or train mode;
* `vae.py`: one sigma-VAE training step with Adam on its schedule.

Nothing here imports the port (`pyqg_generative_torch`), the JAX package
or JAX. `precision(mode)` sets the arithmetic: "float32" (TF32 off, the
configurations' precision), "tf32" (TF32 on: the control one step below)
and "bfloat16" (every convolution's input and weights rounded to bf16,
float32 sums: a control that the CPU can run).
"""
from __future__ import annotations

import contextlib

import torch

MODES = ("float32", "tf32", "bfloat16")


@contextlib.contextmanager
def precision(mode: str = "float32", cudnn: bool = True):
    """TF32 off for "float32" and "bfloat16", on for "tf32"; cuDNN's
    algorithms deterministic; with `cudnn=False` PyTorch's own
    convolutions (im2col and GEMM) in place of cuDNN's, whose weight
    gradients of 5x5 convolutions lose float32's precision."""
    if mode not in MODES:
        raise ValueError(f"precision {mode!r}: one of {MODES}")
    b = torch.backends
    prev = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
            b.cudnn.deterministic, b.cudnn.enabled)
    tf32 = mode == "tf32"
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32
    b.cudnn.deterministic = True
    b.cudnn.enabled = cudnn
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cudnn.deterministic, b.cudnn.enabled) = prev
