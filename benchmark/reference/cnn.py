"""The AndrewCNN of the closures, plain PyTorch, from flax msgpack weights.

Follows the architecture of Perezhogin, Zanna and Fernandez-Granda (JAMES
2023, doi:10.1029/2023MS003681, section 3 and the `AndrewCNN` of their code,
after Guan et al. and Zanna and Bolton): eight circular "same"
convolutions, kernels 5, 5, 3, 3, 3, 3, 3, 3, hidden channels 128, 64, 32,
32, 32, 32, 32, each hidden convolution followed by ReLU and then
BatchNorm (eps 1e-5; in training mode the batch's mean and biased variance
normalise, and the running statistics move 0.9 old + 0.1 batch, flax's
momentum). Circular padding wraps (k - 1) // 2 cells on each side.

Departures: none in the arithmetic. The weights are the flax tree of the
committed msgpack files (kernels HWIO, BatchNorm `scale`/`bias` in
`params`, `mean`/`var` in `batch_stats`), read here with `msgpack`
itself: a flax file is a msgpack map whose arrays are extension type 1
holding [shape, dtype name, C-order bytes]. Layouts are NCHW.
"""
from __future__ import annotations

import msgpack
import numpy as np
import torch
import torch.nn.functional as F

KERNELS = (5, 5, 3, 3, 3, 3, 3, 3)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _ext_hook(code: int, data: bytes):
    if code in (1, 3):  # an array, a numpy scalar
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    raise ValueError(f"msgpack extension type {code} in a weights file")


def read_weights(path: str) -> dict:
    """The flax variable tree of a msgpack weights file, numpy leaves."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)


def _round(t: torch.Tensor, mode: str) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if mode == "bfloat16" else t


class AndrewCNN:
    """The net as tensors: `convs` [(weight OIHW, bias)], `norms` [(scale,
    bias)] and `stats` [(mean, var)], on `device` in float32. Calling it
    runs eval mode (the running statistics) or, with `train=True`, train
    mode, which moves the running statistics."""

    def __init__(self, variables: dict, device, n_layers: int = 8,
                 requires_grad: bool = False):
        params = variables["params"]
        stats = variables.get("batch_stats", {})

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device,
                                requires_grad=requires_grad)

        self.convs = [(t(np.transpose(params[f"Conv_{i}"]["kernel"],
                                      (3, 2, 0, 1))),
                       t(params[f"Conv_{i}"]["bias"]))
                      for i in range(n_layers)]
        self.norms = [(t(params[f"BatchNorm_{i}"]["scale"]),
                       t(params[f"BatchNorm_{i}"]["bias"]))
                      for i in range(n_layers - 1)]
        self.stats = [(torch.tensor(np.asarray(stats[f"BatchNorm_{i}"]["mean"],
                                               np.float32), device=device),
                       torch.tensor(np.asarray(stats[f"BatchNorm_{i}"]["var"],
                                               np.float32), device=device))
                      for i in range(n_layers - 1)]

    def parameters(self) -> dict:
        """Trainable tensors by the flax path's name, encoder-agnostic:
        Conv_i.kernel, Conv_i.bias, BatchNorm_i.scale, BatchNorm_i.bias."""
        out = {}
        for i, (w, b) in enumerate(self.convs):
            out[f"Conv_{i}.kernel"], out[f"Conv_{i}.bias"] = w, b
        for i, (s, b) in enumerate(self.norms):
            out[f"BatchNorm_{i}.scale"], out[f"BatchNorm_{i}.bias"] = s, b
        return out

    def statistics(self) -> dict:
        out = {}
        for i, (m, v) in enumerate(self.stats):
            out[f"BatchNorm_{i}.mean"], out[f"BatchNorm_{i}.var"] = m, v
        return out

    def __call__(self, x: torch.Tensor, train: bool = False,
                 mode: str = "float32") -> torch.Tensor:
        last = len(self.convs) - 1
        for i, (w, b) in enumerate(self.convs):
            k = w.shape[-1]
            lo = (k - 1) // 2
            x = F.pad(x, (lo, k - 1 - lo, lo, k - 1 - lo), mode="circular")
            x = F.conv2d(_round(x, mode), _round(w, mode), b)
            if i == last:
                break
            x = torch.relu(x)
            scale, bias = self.norms[i]
            mean, var = self.stats[i]
            if train:
                bmean = x.mean(dim=(0, 2, 3))
                bvar = ((x - bmean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
                with torch.no_grad():
                    mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * bmean)
                    var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * bvar)
                mean, var = bmean, bvar
            x = (x - mean[:, None, None]) \
                * (torch.rsqrt(var + BN_EPS) * scale)[:, None, None] \
                + bias[:, None, None]
        return x
