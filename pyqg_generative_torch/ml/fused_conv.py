"""The online closure CNN: Conv_0 in PyTorch, Conv_1..Conv_n in kernel K1.

K1 (`csrc/fused_conv.cu`) replaces the Pallas kernel
`pyqg_generative_tpu/ml/pallas_conv.py::_fused_call` in its variant "dx"
(`_conv_dx`): the BatchNorm-folded AndrewCNN after its first layer, as a
chain of circular "same" convolutions with bias on every layer and ReLU on all
but the last, in float32. The first layer (4 -> 128 channels, about 5% of the
FLOPs) stays outside the kernel, as in `make_online_cnn.first_layer` of the
twin.

Bound on an H100 at the main path's shapes (10 members, 64^2, eddy_gan_64
widths): 2.136 GFLOP per member-step, 21.4 GFLOP a call, 0.32 ms at the
67 TFLOP/s float32 peak outside the tensor cores; the 22 MB it must move take
7 us at 3.35 TB/s, so K1 is bound by operations. The kernel's design and what
later work changes are in the source's header.

`fused_cnn_forward` takes K1's plain PyTorch version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. `launches` counts
its kernel calls.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_fp32, resolve_device
from .nets import circular_conv2d

__all__ = ["PackedCNN", "pack_folded_params", "fused_cnn_forward",
           "fused_cnn_forward_plain", "make_online_cnn", "launches",
           "flops_per_member"]

# K1 calls made by fused_cnn_forward on CUDA tensors (each call enqueues the
# whole Conv_1..Conv_n chain).
launches = 0

# Names of the twin's kernel variants; on Hopper "dx" and "tap" are one
# float32 kernel. The bf16 variants and the member-packed one are later work.
_VARIANTS = ("dx", "tap")


@dataclass(frozen=True)
class PackedCNN:
    """BN-folded conv chain on one device: per layer an OIHW kernel and a
    bias for the plain version, and the same weights as HWIO packed back to
    back (`wflat`, `bflat`) for K1. meta = ((K, cin, cout), ...)."""
    weights: tuple
    biases: tuple
    wflat: torch.Tensor
    bflat: torch.Tensor
    meta: tuple


def pack_folded_params(folded: dict, device) -> PackedCNN:
    """Pack BN-folded AndrewCNN params ({'params': {'Conv_i': {kernel
    (K,K,Cin,Cout), bias}}}, flax layout) for the plain version and K1."""
    params = folded["params"]
    n = len([k for k in params if k.startswith("Conv_")])
    weights, biases, hwio, meta = [], [], [], []
    for i in range(n):
        k = np.asarray(params[f"Conv_{i}"]["kernel"], np.float32)
        b = np.asarray(params[f"Conv_{i}"].get(
            "bias", np.zeros(k.shape[-1])), np.float32)
        K, K2, cin, cout = k.shape
        if K != K2 or K % 2 == 0:
            raise ValueError("square kernels of odd size only")
        hwio.append(k.ravel())
        weights.append(torch.as_tensor(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)), device=device))
        biases.append(torch.as_tensor(b, device=device))
        meta.append((K, cin, cout))
    for (_, _, cout), (_, cin, _) in zip(meta[:-1], meta[1:]):
        if cout != cin:
            raise ValueError("layer widths do not chain")
    return PackedCNN(
        weights=tuple(weights), biases=tuple(biases),
        wflat=torch.as_tensor(np.concatenate(hwio), device=device),
        bflat=torch.cat(biases), meta=tuple(meta))


def flops_per_member(meta, H: int, W: int) -> float:
    """Operations of one member's chain: 2*K^2*cin*cout per pixel and
    layer."""
    return float(sum(2 * K * K * cin * cout for K, cin, cout in meta) * H * W)


def fused_cnn_forward_plain(x: torch.Tensor,
                            packed: PackedCNN) -> torch.Tensor:
    """K1's function in plain PyTorch: x (B, H, W, Cin0) -> (B, H, W,
    Cout), float32, TF32 off."""
    act = x.permute(0, 3, 1, 2)
    n = len(packed.weights)
    with exact_fp32():
        for i, (w, b) in enumerate(zip(packed.weights, packed.biases)):
            act = circular_conv2d(act, w, b)
            if i < n - 1:
                act = F.relu(act)
    return act.permute(0, 2, 3, 1).contiguous()


@lru_cache(maxsize=None)
def _k1_function():
    """K1's C entry point, built and loaded at its first launch."""
    from ._build import load_library
    fn = load_library("fused_conv").k1_fused_cnn_forward_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def _k1(x: torch.Tensor, packed: PackedCNN) -> torch.Tensor:
    global launches
    fn = _k1_function()
    B, H, W, _ = x.shape
    n_out = packed.meta[-1][2]
    hidden = max((cout for _, _, cout in packed.meta[:-1]), default=0)
    out = torch.empty((B, H, W, n_out), dtype=torch.float32, device=x.device)
    scratch = torch.empty(2 * B * H * W * hidden, dtype=torch.float32,
                          device=x.device)
    flat = [v for m in packed.meta for v in m]
    meta = (ctypes.c_int * len(flat))(*flat)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), packed.wflat.data_ptr(), packed.bflat.data_ptr(),
             meta, len(packed.meta), out.data_ptr(), scratch.data_ptr(),
             B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    launches += 1
    return out


def fused_cnn_forward(x: torch.Tensor, packed: PackedCNN) -> torch.Tensor:
    """The Conv_1..Conv_n chain on x (B, H, W, Cin0) float32 NHWC. A CPU
    tensor takes the plain version; a CUDA tensor launches K1."""
    if x.ndim != 4 or x.shape[-1] != packed.meta[0][1]:
        raise ValueError(f"expected (B, H, W, {packed.meta[0][1]}), "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_cnn_forward_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 for device {x.device}")
    if packed.wflat.device != x.device:
        raise ValueError("weights and input lie on different devices")
    return _k1(x.contiguous(), packed)


def make_online_cnn(folded: dict, compute_dtype=torch.float32,
                    variant: str = "dx", device=None):
    """The online forward of a BN-folded AndrewCNN: Conv_0 + ReLU as a
    circular conv in PyTorch (TF32 off), then Conv_1..Conv_n through
    `fused_cnn_forward`. Returns apply(x) for x (H, W, Cin) or (B, H, W, Cin)
    giving float32 (..., H, W, n_out)."""
    if compute_dtype != torch.float32:
        raise NotImplementedError("K1 runs in float32; bf16 is later work")
    if variant not in _VARIANTS:
        raise NotImplementedError(
            f"variant {variant!r}: only {_VARIANTS} are ported")
    device = resolve_device(device)
    params = folded["params"]
    k0 = torch.as_tensor(np.ascontiguousarray(np.asarray(
        params["Conv_0"]["kernel"], np.float32).transpose(3, 2, 0, 1)),
        device=device)
    b0 = torch.as_tensor(np.asarray(params["Conv_0"]["bias"], np.float32),
                         device=device)
    packed = pack_folded_params(
        {"params": {f"Conv_{i - 1}": params[f"Conv_{i}"]
                    for i in range(1, len(params))}}, device)

    def first_layer(x: torch.Tensor) -> torch.Tensor:
        """Conv_0 + ReLU: (B, H, W, Cin) -> K1's input (B, H, W, 128)."""
        with exact_fp32():
            act = F.relu(circular_conv2d(
                x.to(torch.float32).permute(0, 3, 1, 2), k0, b0))
        return act.permute(0, 2, 3, 1).contiguous()

    def apply(x: torch.Tensor) -> torch.Tensor:
        squeeze = x.ndim == 3
        out = fused_cnn_forward(first_layer(x[None] if squeeze else x),
                                packed)
        return out[0] if squeeze else out

    apply.first_layer, apply.packed = first_layer, packed
    return apply
