"""Batched inference of the offline predictions.

Twin of `apply_in_batches` in `pyqg_generative_tpu/ml/train.py` (:308-321).
The rest of the twin's module, the training loops, waits for the training
slice.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["apply_in_batches"]


def apply_in_batches(fn: Callable, *arrays, batch_size: int = 64,
                     device=None):
    """`fn` over consecutive batches of `arrays` (numpy or tensors, batch
    axis first), each batch handed over as tensors on `device` (the arrays'
    own where None), its outputs copied to the host and concatenated there
    (replaces the reference's `apply_function`, tools/cnn_tools.py:702-735).
    `fn` maps a tuple of batches to a tensor or a tuple of tensors; returns
    a numpy array or a list of them."""
    n = arrays[0].shape[0]
    outs = []
    for i in range(0, n, batch_size):
        batch = tuple(torch.as_tensor(a[i:i + batch_size], device=device)
                      for a in arrays)
        y = fn(*batch)
        y = (y,) if not isinstance(y, (tuple, list)) else y
        outs.append([v.cpu().numpy() for v in y])
    outs = list(zip(*outs))
    outs = [np.concatenate(o, axis=0) for o in outs]
    return outs[0] if len(outs) == 1 else outs
