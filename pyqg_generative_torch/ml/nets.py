"""The closure CNN as a PyTorch module, and its BatchNorm folding.

Twin of `AndrewCNN`, `VarCNN` and `fold_batchnorm` in
`pyqg_generative_tpu/ml/nets.py`:
the same 8-layer circular CNN (kernels [5,5,3x6], channels [128,64,32x5]),
conv -> ReLU -> BatchNorm after each hidden conv. The module computes in
PyTorch's NCHW but takes and returns NHWC, the twin's layout, so that the two
compare like with like. Weights cross over from the flax tree with
`ml.weights.params_from_jax`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AndrewCNN", "VarCNN", "fold_batchnorm", "circular_conv2d"]

HIDDEN = (128, 64, 32, 32, 32, 32, 32)


def circular_conv2d(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """'Same'-size circular convolution of NCHW `x` with an OIHW kernel of
    odd size (flax `padding="CIRCULAR"`)."""
    r = w.shape[-1] // 2
    return F.conv2d(F.pad(x, (r, r, r, r), mode="circular"), w, b)


class AndrewCNN(nn.Module):
    """8-layer circular CNN, ReLU + BatchNorm after each hidden conv
    (reference tools/cnn_tools.py:125-182). Eval-mode BatchNorm uses the
    running statistics, as the twin does with `train=False`."""

    def __init__(self, n_in: int, n_out: int,
                 hidden_channels: Sequence[int] = HIDDEN,
                 kernels: Sequence[int] = (5, 5, 3, 3, 3, 3, 3, 3),
                 batch_norm: bool = True, bias: bool = True,
                 relu: str = "ReLU", final_activation: str = "None",
                 div: bool = False):
        super().__init__()
        if div:
            raise NotImplementedError(
                "div=True (spectral-divergence head) is not ported yet")
        if any(k % 2 == 0 for k in kernels):
            raise ValueError("circular 'same' convolutions need odd kernels")
        chans = list(hidden_channels) + [n_out]
        cins = [n_in] + chans[:-1]
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, k, bias=bias)
            for ci, co, k in zip(cins, chans, kernels))
        n_hidden = len(self.convs) - 1
        self.bns = nn.ModuleList(
            nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
            for c in chans[:n_hidden]) if batch_norm else None
        self.relu = relu
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC -> (B, H, W, n_out)."""
        x = x.permute(0, 3, 1, 2)
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = circular_conv2d(x, conv.weight, conv.bias)
            if i < last:
                x = F.relu(x) if self.relu == "ReLU" \
                    else F.leaky_relu(x, 0.2)
                if self.bns is not None:
                    x = self.bns[i](x)
        if self.final_activation != "None":
            x = getattr(F, self.final_activation)(x)
        return x.permute(0, 2, 3, 1)


def VarCNN(n_in: int, n_out: int, **kw) -> AndrewCNN:
    """AndrewCNN with a softplus head: the nonnegative pointwise conditional
    variance of the GZ closure."""
    kw.setdefault("final_activation", "softplus")
    return AndrewCNN(n_in, n_out, **kw)


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def fold_batchnorm(variables: dict, eps: float = 1e-5) -> dict:
    """Fold eval-mode BatchNorms of an AndrewCNN into the *following* conv
    (numpy, on the flax tree; the twin's code).

    The stack is conv_i -> relu -> bn_i -> conv_{i+1}; in eval mode
    bn_i(z) = a * z + b with a = gamma/sqrt(var+eps), b = beta - mean*a.
    Because b is spatially constant and the padding is circular,
    conv_{i+1}(a*z + b) = conv'_{i+1}(z) exactly, with the kernel scaled per
    input channel by a and the bias shifted by sum W[..., cin, :] b[cin].
    Returns params for the same architecture with `batch_norm=False`.
    """
    params = _to_numpy_tree(variables["params"])
    stats = _to_numpy_tree(variables["batch_stats"])
    n_bn = len([k for k in params if k.startswith("BatchNorm")])
    out = {}
    for i in range(n_bn + 1):
        conv = dict(params[f"Conv_{i}"])
        if i > 0:
            bn_p = params[f"BatchNorm_{i - 1}"]
            bn_s = stats[f"BatchNorm_{i - 1}"]
            a = bn_p["scale"] / np.sqrt(bn_s["var"] + eps)
            b = bn_p["bias"] - bn_s["mean"] * a
            kernel = conv["kernel"] * a[None, None, :, None]
            bias = conv.get("bias", 0.0) + np.einsum(
                "hwio,i->o", conv["kernel"], b)
            conv = {"kernel": kernel, "bias": bias.astype(kernel.dtype)}
        out[f"Conv_{i}"] = conv
    return {"params": out, "batch_stats": {}}
