"""Device selection and float32 exactness for the port's entry points."""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["resolve_device", "exact_fp32"]


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
