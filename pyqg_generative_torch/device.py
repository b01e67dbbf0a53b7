"""Device selection and float32 exactness for the port's entry points."""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["resolve_device", "exact_fp32", "exact_fp32_training"]


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; raise rather than run on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextmanager
def exact_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (no TF32), the
    precision of the JAX reference's float32 path, on deterministic cuDNN
    algorithms: cuDNN's transposed convolutions may otherwise sum with
    atomics, in another order at each call, so that a replayed graph would
    not equal the eager step. (Its forward algorithms are deterministic
    whatever the flag.)"""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev


@contextmanager
def exact_fp32_training():
    """`exact_fp32` with PyTorch's own convolutions (im2col and cuBLAS
    GEMMs, deterministic) in place of cuDNN's, for a training step's forward
    and backward. cuDNN's deterministic weight-gradient algorithms for the
    closures' 5x5 convolutions lose float32's precision: on an H100 a
    128 -> 64 5x5 conv at 8 x 64^2 reads 2.3e-3 from float64 in relative
    RMS, 4 -> 32 at 4 x 32^2 7.5e-4, where PyTorch's own path reads 2e-7 to
    5e-7 (`scripts/torch_training_precision.py`; PERF.md, PR 11)."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with exact_fp32():
            yield
    finally:
        torch.backends.cudnn.enabled = prev
