"""The online closure CNN: Conv_0 in PyTorch, Conv_1..Conv_n in a kernel.

Twin of `pyqg_generative_tpu/ml/pallas_conv.py`. Three hand-written CUDA
kernels replace its Pallas kernels; each has a plain PyTorch version here,
which a wrapper takes only for a tensor on the CPU (for a CUDA tensor it
launches its kernel or raises), and a launch count:

* K1 (`csrc/fused_conv.cu`) replaces `_fused_call` in its per-member
  variants "dx", "tap", "dxf" and "dxb": the BatchNorm-folded AndrewCNN after
  its first layer, as a chain of circular "same" convolutions with bias on
  every layer and ReLU on all but the last. It runs in float32 or, with
  `compute_dtype=torch.bfloat16`, on bf16 inputs and weights with float32
  accumulation, bias, ReLU and output, as the twin does; in bf16 on the
  tensor cores (`csrc/conv_mma_bf16.cuh`), skipping the zero blocks of a
  block-diagonal layer. Wrapper `fused_cnn_forward`; counts `launches`
  (float32) and `launches_bf16`.
* K2 (`csrc/packed_chain.cu`) replaces `_fused_call_packed`, the variant
  "packed": the same chain for the whole ensemble packed into one launch,
  on K1's NHWC layout (the twin's member-packed (H*W, B*C) layout survives
  only in the plain version). Wrapper `packed_cnn_forward`; counts
  `launches_packed`. K1 in float32 and K2 run one FMA tile body
  (`csrc/conv_fma.cuh`).
* K3 (`csrc/bitcast_probe.cu`) replaces `_bitcast_packing`, the probe of how
  bf16 pairs pack into 32-bit words that resolves "dxb". Wrapper
  `bitcast_pack_words`; counts `launches_probe`. On Hopper "dxb" and its
  fallback "dxf" are the same kernel, so the probe names the variant and
  changes no arithmetic.

The first layer (4 -> 128 channels, about 5% of the FLOPs) stays outside the
kernels in float32 (cuDNN, TF32 off), as `make_online_cnn.first_layer` of the
twin. The kernels' bounds and designs are in their sources' headers.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_fp32, resolve_device
from ..utils import profiling
from .nets import circular_conv2d

__all__ = ["PackedCNN", "pack_folded_params", "merge_folded_pair",
           "weight_groups", "tensor_core_weights", "chain_layer",
           "layer_check", "LAYER_BAR",
           "fused_cnn_forward", "fused_cnn_forward_plain",
           "packed_cnn_forward", "packed_cnn_forward_plain",
           "bitcast_pack_words", "bitcast_pack_words_plain",
           "bitcast_packing", "resolve_variant", "compute_dtype_of",
           "make_online_cnn", "flops_per_member", "graph_kernel_nodes"]

# Kernel calls made by the wrappers on CUDA tensors (a K1 call enqueues the
# whole Conv_1..Conv_n chain, one launch per layer; a K2 call is one launch),
# as counters of `utils.profiling`; `fused_conv.launches` and the others
# read them.
COUNTERS = {"launches": "fused_conv.launches",                # K1, float32
            "launches_bf16": "fused_conv.launches_bf16",      # K1, bf16
            "launches_packed": "fused_conv.launches_packed",  # K2
            "launches_probe": "fused_conv.launches_probe"}    # K3
for _name in COUNTERS.values():
    profiling.count(_name, 0)


def __getattr__(name):
    if name in COUNTERS:
        return profiling.counters().get(COUNTERS[name], 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# The twin's variant names and the kernel each maps to on Hopper. A name
# ending in "pair" is resolved by the GZ model (`MeanVarModel`).
VARIANTS = {"dx": "k1", "tap": "k1", "dxf": "k1", "dxb": "k1",
            "packed": "k2"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """The compute dtype of a model's `inference_dtype` argument."""
    if name not in _DTYPES:
        raise ValueError(f"inference_dtype {name!r}: one of {list(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class PackedCNN:
    """BN-folded conv chain on one device: per layer an OIHW kernel and a
    bias for the plain versions (the kernel rounded to bf16 where `dtype` is
    bf16, held as float32), and the same weights as HWIO packed back to back
    in `dtype` (`wflat`) with float32 biases (`bflat`) for K1 in float32 and
    K2. meta = ((K, cin, cout), ...); `groups` holds each layer's number of
    diagonal blocks (`weight_groups`). In bf16, `wtc` holds the weights of
    those blocks in K1-bf16's tensor-core layout (`tensor_core_weights`),
    back to back."""
    weights: tuple
    biases: tuple
    wflat: torch.Tensor
    bflat: torch.Tensor
    meta: tuple
    dtype: torch.dtype = torch.float32
    groups: tuple = ()
    wtc: torch.Tensor | None = None


def weight_groups(kernel: np.ndarray) -> int:
    """The largest G for which an HWIO kernel (K, K, cin, cout) is
    block-diagonal: every weight outside the G diagonal (cin/G, cout/G)
    blocks is an exact zero (1 for a dense layer). The merged GZ pair's
    layers after the first have G = 2 (`merge_folded_pair`)."""
    K2, cin, cout = kernel.shape[0] * kernel.shape[1], *kernel.shape[2:]
    nz = kernel.reshape(K2, cin, cout) != 0
    for G in range(math.gcd(cin, cout), 1, -1):
        if cin % G or cout % G:
            continue
        blocks = nz.reshape(K2, G, cin // G, G, cout // G).any(
            axis=(0, 2, 4))
        if not (blocks & ~np.eye(G, dtype=bool)).any():
            return G
    return 1


KC = 16  # input channels of one wgmma k-step (csrc/conv_mma_bf16.cuh)


def n_tile(cout_g: int) -> int:
    """Output channels a K1-bf16 block computes for a group of `cout_g`
    (csrc/conv_mma_bf16.cuh::n_tile)."""
    return next((n for n in (8, 16, 32) if cout_g <= n), 64)


def tensor_core_weights(kernel: np.ndarray, groups: int) -> np.ndarray:
    """An HWIO kernel (K, K, cin, cout) of `groups` diagonal blocks in
    K1-bf16's layout, flat: per (group, n-tile of N output channels, chunk
    of 16 input channels, tap ky*K + kx), the 16 x N block as two 8-channel
    halves of N rows of 8 channels, [half][n][8], each 8 x 8 a contiguous
    wgmma core matrix. Channels past a group's width are zero."""
    K, _, cin, cout = kernel.shape
    cin_g, cout_g = cin // groups, cout // groups
    N = n_tile(cout_g)
    nt, nc = -(-cout_g // N), -(-cin_g // KC)
    out = np.zeros((groups, K * K, nc * KC, nt * N), np.float32)
    for g in range(groups):
        out[g, :, :cin_g, :cout_g] = kernel[
            :, :, g * cin_g:(g + 1) * cin_g,
            g * cout_g:(g + 1) * cout_g].reshape(K * K, cin_g, cout_g)
    # (g, tap, c, half, k, t, n) -> (g, t, c, tap, half, n, k)
    out = out.reshape(groups, K * K, nc, 2, 8, nt, N)
    return out.transpose(0, 5, 2, 1, 3, 6, 4).ravel()


def _tc_elems(meta, groups: int) -> int:
    """Elements of one layer's tensor-core weights
    (csrc/conv_mma_bf16.cuh::packed_weight_elems)."""
    K, cin, cout = meta
    cin_g, cout_g = cin // groups, cout // groups
    N = n_tile(cout_g)
    return groups * -(-cout_g // N) * -(-cin_g // KC) * K * K * N * KC


def pack_folded_params(folded: dict, device,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> PackedCNN:
    """Pack BN-folded AndrewCNN params ({'params': {'Conv_i': {kernel
    (K,K,Cin,Cout), bias}}}, flax layout) for the plain versions and the
    kernels; weights in `compute_dtype`, biases in float32. Each layer's
    groups are read off its weights (`weight_groups`)."""
    if compute_dtype not in _DTYPES.values():
        raise TypeError(f"compute dtype {compute_dtype}: float32 or bfloat16")
    params = folded["params"]
    n = len([k for k in params if k.startswith("Conv_")])
    weights, biases, hwio, meta, groups, tc = [], [], [], [], [], []
    for i in range(n):
        k = np.asarray(params[f"Conv_{i}"]["kernel"], np.float32)
        b = np.asarray(params[f"Conv_{i}"].get(
            "bias", np.zeros(k.shape[-1])), np.float32)
        K, K2, cin, cout = k.shape
        if K != K2 or K % 2 == 0:
            raise ValueError("square kernels of odd size only")
        hwio.append(k.ravel())
        w = torch.as_tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)),
                            device=device)
        weights.append(w.to(compute_dtype).to(torch.float32))
        biases.append(torch.as_tensor(b, device=device))
        meta.append((K, cin, cout))
        groups.append(weight_groups(k))
        if compute_dtype == torch.bfloat16:
            tc.append(tensor_core_weights(k, groups[-1]))
    for (_, _, cout), (_, cin, _) in zip(meta[:-1], meta[1:]):
        if cout != cin:
            raise ValueError("layer widths do not chain")
    return PackedCNN(
        weights=tuple(weights), biases=tuple(biases),
        wflat=torch.as_tensor(np.concatenate(hwio), device=device).to(
            compute_dtype),
        bflat=torch.cat(biases), meta=tuple(meta), dtype=compute_dtype,
        groups=tuple(groups),
        wtc=torch.as_tensor(np.concatenate(tc), device=device).to(
            compute_dtype) if tc else None)


def chain_layer(packed: PackedCNN, i: int) -> PackedCNN:
    """Layer i of a chain as a one-layer chain, on views of its buffers. A
    kernel runs it as it runs any chain: its output is the float32 sum plus
    bias, with no ReLU and no rounding."""
    def offset(sizes):
        return sum(sizes[:i]), sizes[i]

    meta = packed.meta
    w0, nw = offset([K * K * cin * cout for K, cin, cout in meta])
    b0, nb = offset([cout for _, _, cout in meta])
    wtc = None
    if packed.wtc is not None:
        t0, nt = offset([_tc_elems(m, g)
                         for m, g in zip(meta, packed.groups)])
        wtc = packed.wtc[t0:t0 + nt]
    return PackedCNN(
        weights=(packed.weights[i],), biases=(packed.biases[i],),
        wflat=packed.wflat[w0:w0 + nw], bflat=packed.bflat[b0:b0 + nb],
        meta=(meta[i],), dtype=packed.dtype, groups=(packed.groups[i],),
        wtc=wtc)


def merge_folded_pair(folded_a: dict, folded_b: dict) -> dict:
    """Merge two BN-folded CNNs of the same structure into ONE network that
    is block-diagonal over channels (the twin's numpy code), so that one
    kernel call runs GZ's mean and variance nets. Layer 0 reads the shared
    input: kernels concatenated along cout. Layers 1..n: block-diagonal over
    (cin, cout). Outputs concatenate [out_a | out_b]."""
    pa, pb = folded_a["params"], folded_b["params"]
    n = len([k for k in pa if k.startswith("Conv_")])
    if n != len([k for k in pb if k.startswith("Conv_")]):
        raise ValueError("pair nets must have the same depth")
    out = {}
    for i in range(n):
        ka = np.asarray(pa[f"Conv_{i}"]["kernel"])
        kb = np.asarray(pb[f"Conv_{i}"]["kernel"])
        ba = np.asarray(pa[f"Conv_{i}"].get("bias", np.zeros(ka.shape[-1])))
        bb = np.asarray(pb[f"Conv_{i}"].get("bias", np.zeros(kb.shape[-1])))
        if ka.shape[:2] != kb.shape[:2]:
            raise ValueError("pair nets must share K")
        K, _, cina, couta = ka.shape
        cinb, coutb = kb.shape[2], kb.shape[3]
        if i == 0:
            if cina != cinb:
                raise ValueError("pair nets must share the input")
            k = np.concatenate([ka, kb], axis=3)
        else:
            k = np.zeros((K, K, cina + cinb, couta + coutb), ka.dtype)
            k[:, :, :cina, :couta] = ka
            k[:, :, cina:, couta:] = kb
        out[f"Conv_{i}"] = {"kernel": k, "bias": np.concatenate([ba, bb])}
    return {"params": out}


def flops_per_member(meta, H: int, W: int) -> float:
    """Operations of one member's chain: 2*K^2*cin*cout per pixel and
    layer."""
    return float(sum(2 * K * K * cin * cout for K, cin, cout in meta) * H * W)


def _round(act: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The twin's cast at a conv's input, held in float32."""
    return act if dtype == torch.float32 else act.to(dtype).to(torch.float32)


# ------------------------------------------------------------------ K1
def fused_cnn_forward_plain(x: torch.Tensor,
                            packed: PackedCNN) -> torch.Tensor:
    """K1's function in plain PyTorch: x (B, H, W, Cin0) -> (B, H, W,
    Cout), float32 convolutions with TF32 off, on inputs rounded to the
    compute dtype at each conv."""
    act = x.permute(0, 3, 1, 2)
    n = len(packed.weights)
    with exact_fp32():
        for i, (w, b) in enumerate(zip(packed.weights, packed.biases)):
            act = circular_conv2d(_round(act, packed.dtype), w, b)
            if i < n - 1:
                act = F.relu(act)
    return act.permute(0, 2, 3, 1).contiguous()


# The per-layer bar of `layer_check`: relative RMS against float64. A
# kernel that sums in its own order (K1-bf16 on the tensor cores) cannot be
# held to its plain version over the chain, since each flipped bf16 rounding
# cascades through the layers (relative RMS 1e-3 to 3e-3 on an H100). Per
# layer, on bf16 inputs, both are float32 sums of exact products: scaling a
# layer by 1 + 1e-4 reads 1e-4, over the bar, while a correct 3,200-term
# sum (Conv_1 of the merged GZ pair) stays near 3e-6.
LAYER_BAR = 3e-5


def layer_check(x: torch.Tensor, packed: PackedCNN, forward=None) -> dict:
    """The check of a chain kernel that may sum in its own order, on x (B,
    H, W, Cin0), in two parts that each hold to float32's own accuracy.
    `forward` is the chain's wrapper: `fused_cnn_forward` (K1, the default)
    or `packed_cnn_forward` (K2).
    1. each layer, run by `forward` as a one-layer chain (`chain_layer`) on
       its input as the plain chain computes it, rounded to the compute
       dtype (so the kernel's own cast at staging is exact), against the
       same layer in float64: "layers" lists (relative RMS, max|err|, the
       plain version's max|err| against float64), to hold to LAYER_BAR;
    2. "composed_equal": whether the chain equals its one-layer calls in
       turn, with torch.relu and the rounding to the compute dtype between
       them, bitwise. This holds the chain's wiring: weight offsets,
       groups, scratch, ReLU and rounding, the float32 last layer."""
    forward = forward or fused_cnn_forward
    n = len(packed.meta)
    layers, act = [], x
    for i in range(n):
        one = chain_layer(packed, i)
        xi = _round(act, packed.dtype).contiguous()
        out = forward(xi, one).double()
        ref = circular_conv2d(xi.double().permute(0, 3, 1, 2),
                              one.weights[0].double(),
                              one.biases[0].double()).permute(0, 2, 3, 1)
        plain = fused_cnn_forward_plain(xi, one)
        layers.append((float(((out - ref) ** 2).mean().sqrt()
                             / (ref ** 2).mean().sqrt()),
                       float((out - ref).abs().max()),
                       float((plain.double() - ref).abs().max())))
        act = F.relu(plain)
    chain = forward(x, packed)
    act = x
    for i in range(n):
        act = forward(act, chain_layer(packed, i))
        if i < n - 1:
            act = _round(torch.relu(act), packed.dtype)
    return {"layers": layers, "composed_equal": torch.equal(chain, act)}


def _bind(library: str, symbol: str, argtypes):
    from ._build import load_library
    fn = getattr(load_library(library), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


# x, wflat, bflat, meta, n_layers, out, scratch, B, H, W, stream; K2 adds
# its counters
_CHAIN_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_K2_ARGS = _CHAIN_ARGS + [ctypes.c_void_p]


@lru_cache(maxsize=None)
def _chain_function(library: str, dtype: torch.dtype):
    """The C entry point of K1 or K2 for `dtype`, built and loaded at its
    first launch."""
    prefix = {"fused_conv": "k1_fused", "packed_chain": "k2_packed"}[library]
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    return _bind(library, f"{prefix}_cnn_forward_{suffix}",
                 _K2_ARGS if library == "packed_chain" else _CHAIN_ARGS)


# K2's work-item counters by (device index, stream): a zeroed buffer a
# stream, which each launch leaves zero (csrc/packed_chain.cu::Counters), so
# that launches on two streams never draw each other's items. A graph that
# captures K2 holds its stream's buffer, which is therefore allocated by an
# eager launch on that stream before any capture, never under one.
_k2_counters: dict = {}


def _k2_counter_buffer(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _k2_counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K2's counters for this stream would be "
                               "allocated under graph capture: launch K2 "
                               "eagerly on the capture stream first")
        words = _bind("packed_chain", "k2_counter_words", [])()
        _k2_counters[key] = torch.zeros(words, dtype=torch.int32,
                                        device=device)
    return _k2_counters[key]


def graph_kernel_nodes(graph: int) -> tuple[int, int]:
    """(kernel nodes, cooperative kernel nodes) of a CUDA graph, by its
    `cudaGraph_t` handle (`torch.cuda.CUDAGraph.raw_cuda_graph()`)."""
    kernels, cooperative = ctypes.c_int(), ctypes.c_int()
    err = _bind("packed_chain", "k2_graph_kernel_nodes",
                [ctypes.c_void_p] * 3)(graph, ctypes.byref(kernels),
                                       ctypes.byref(cooperative))
    if err != 0:
        raise RuntimeError(f"reading the graph's nodes failed: cudaError "
                           f"{err}")
    return kernels.value, cooperative.value


def _launch_chain(library: str, x: torch.Tensor, packed: PackedCNN,
                  out_shape, B: int, H: int, W: int) -> torch.Tensor:
    """Allocate the output and the ping-pong scratch, and launch the chain
    kernel of `library` on the current stream; raise if it is refused.
    K1-bf16 takes the tensor-core weights and (K, cin, cout, groups) a
    layer; K1 in float32 and K2 the HWIO weights and (K, cin, cout); K2
    also the current stream's counter buffer."""
    if packed.wflat.device != x.device:
        raise ValueError("weights and input lie on different devices")
    fn = _chain_function(library, packed.dtype)
    hidden = max((cout for _, _, cout in packed.meta[:-1]), default=0)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    scratch = torch.empty(2 * B * H * W * hidden, dtype=packed.dtype,
                          device=x.device)
    if library == "fused_conv" and packed.dtype == torch.bfloat16:
        wbuf = packed.wtc
        flat = [v for m, g in zip(packed.meta, packed.groups)
                for v in (*m, g)]
    else:
        wbuf = packed.wflat
        flat = [v for m in packed.meta for v in m]
    meta = (ctypes.c_int * len(flat))(*flat)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [x.data_ptr(), wbuf.data_ptr(), packed.bflat.data_ptr(), meta,
            len(packed.meta), out.data_ptr(), scratch.data_ptr(), B, H, W,
            stream]
    if library == "packed_chain":
        args.append(_k2_counter_buffer(x.device, stream).data_ptr())
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{library} launch failed: cudaError {err}")
    return out


def _check_chain_input(x: torch.Tensor, packed: PackedCNN, name: str):
    if x.ndim != 4 or x.shape[-1] != packed.meta[0][1]:
        raise ValueError(f"expected (B, H, W, {packed.meta[0][1]}), "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 input, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {x.device}")


def fused_cnn_forward(x: torch.Tensor, packed: PackedCNN) -> torch.Tensor:
    """The Conv_1..Conv_n chain on x (B, H, W, Cin0) float32 NHWC, in
    `packed.dtype`. A CPU tensor takes the plain version; a CUDA tensor
    launches K1."""
    _check_chain_input(x, packed, "K1")
    if x.device.type == "cpu":
        return fused_cnn_forward_plain(x, packed)
    B, H, W, _ = x.shape
    out = _launch_chain("fused_conv", x.contiguous(), packed,
                        (B, H, W, packed.meta[-1][2]), B, H, W)
    profiling.count("fused_conv.launches" if packed.dtype == torch.float32
                    else "fused_conv.launches_bf16")
    return out


# ------------------------------------------------------------------ K2
def packed_cnn_forward_plain(x: torch.Tensor,
                             packed: PackedCNN) -> torch.Tensor:
    """K2's function in plain PyTorch, formulated as the twin's packed
    kernel on its member-packed layout (H*W, B*C): per layer, per tap
    s = (dy, dx), one matmul of the rounded activation with the tap's
    (cin, cout) slice of the tap-major weights, accumulated circularly
    shifted, acc[h, w] += y_s[h + dy, w + dx] (one `torch.roll`); then bias,
    and ReLU on all but the last layer. x (B, H, W, Cin0) NHWC -> (B, H, W,
    Cout), float32 with TF32 off; the member-packed layout lives inside."""
    B, H, W, _ = x.shape
    act = x.permute(1, 2, 0, 3).contiguous()  # the twin's (H*W, B*C)
    n = len(packed.meta)
    with exact_fp32():
        for i, ((K, cin, cout), w, b) in enumerate(
                zip(packed.meta, packed.weights, packed.biases)):
            taps = w.permute(2, 3, 1, 0).reshape(K * K, cin, cout)
            a = _round(act, packed.dtype)
            c = K // 2
            acc = torch.zeros((H, W, B, cout), dtype=torch.float32,
                              device=x.device)
            for s in range(K * K):
                dy, dx = s // K - c, s % K - c
                acc += torch.roll(a @ taps[s], shifts=(-dy, -dx),
                                  dims=(0, 1))
            act = acc + b
            if i < n - 1:
                act = F.relu(act)
    return act.permute(2, 0, 1, 3).contiguous()


def packed_cnn_forward(x: torch.Tensor, packed: PackedCNN) -> torch.Tensor:
    """The Conv_1..Conv_n chain on x (B, H, W, Cin0) float32 NHWC, in
    `packed.dtype`, giving (B, H, W, Cout). "Packed" is the whole ensemble
    packed into one launch: a CUDA tensor launches K2 once for all members;
    a CPU tensor takes the plain version."""
    _check_chain_input(x, packed, "K2")
    if x.device.type == "cpu":
        return packed_cnn_forward_plain(x, packed)
    B, H, W, _ = x.shape
    out = _launch_chain("packed_chain", x.contiguous(), packed,
                        (B, H, W, packed.meta[-1][2]), B, H, W)
    profiling.count("fused_conv.launches_packed")
    return out


# ------------------------------------------------------------------ K3
def bitcast_pack_words_plain(x: torch.Tensor) -> torch.Tensor:
    """K3's function in plain PyTorch: x (2R, C) bf16 -> (R, C) int64 words
    in [0, 2^32), word i = bits of row 2i in the low 16 bits and of row
    2i+1 in the high 16 bits, from integer ops on the bf16 bit patterns."""
    bits = x.view(torch.int16).to(torch.int64) & 0xFFFF
    return bits[0::2] | (bits[1::2] << 16)


@lru_cache(maxsize=None)
def _k3_function():
    return _bind("bitcast_probe", "k3_pack_bf16_pairs",
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
                 [ctypes.c_void_p])


def bitcast_pack_words(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit words the device builds from row pairs (2i, 2i+1) of a
    (2R, C) bf16 tensor, as int64 in [0, 2^32). A CPU tensor takes the plain
    version; a CUDA tensor launches K3."""
    if x.dtype != torch.bfloat16 or x.ndim != 2 or x.shape[0] % 2:
        raise ValueError(f"expected (2R, C) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    if x.device.type == "cpu":
        return bitcast_pack_words_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no K3 for device {x.device}")
    out = torch.empty((x.shape[0] // 2, x.shape[1]), dtype=torch.int64,
                      device=x.device)
    err = _k3_function()(x.data_ptr(), out.data_ptr(), out.shape[0],
                         out.shape[1],
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    profiling.count("fused_conv.launches_probe")
    return out


@lru_cache(maxsize=None)
def bitcast_packing(device=None) -> str:
    """How `device` packs a (4, 128) bf16 array into (2, 128) 32-bit words:
    'adj_low' (word i = rows (2i, 2i+1), row 2i in the low 16 bits),
    'adj_high' (row 2i in the high bits) or 'other'. Probed once per device
    with K3 (its plain version on the CPU) and cached, as the twin's
    `_bitcast_packing`; `bitcast_packing.cache_clear()` forgets it."""
    rows = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.bfloat16,
                        device=resolve_device(device))  # 3F80 4000 4040 4080
    words = bitcast_pack_words(rows[:, None].expand(4, 128)).cpu()
    w0, w1 = int(words[0, 0]), int(words[1, 0])
    if (w0, w1) == (0x40003F80, 0x40804040):
        return "adj_low"
    if (w0, w1) == (0x3F804000, 0x40404080):
        return "adj_high"
    return "other"


def resolve_variant(variant: str, device=None):
    """The twin's `_resolve_variant`: 'dxb' is checked against the device's
    probed packing and falls back to 'dxf' on 'other'. Returns (variant,
    low_first)."""
    if variant != "dxb":
        return variant, True
    pack = bitcast_packing(device)
    if pack == "other":
        return "dxf", True
    return "dxb", pack == "adj_low"


# ------------------------------------------------------------ the online CNN
def make_online_cnn(folded: dict, compute_dtype=torch.float32,
                    variant: str = "dx", device=None):
    """The online forward of a BN-folded AndrewCNN: Conv_0 + ReLU as a
    circular conv in PyTorch in float32 (TF32 off), then Conv_1..Conv_n in
    `compute_dtype` through K1's wrapper (variants 'dx', 'tap', 'dxf',
    'dxb') or K2's ('packed'). Returns apply(x) for x (H, W, Cin) or
    (B, H, W, Cin) giving float32 (..., H, W, n_out)."""
    device = resolve_device(device)
    variant, _ = resolve_variant(variant, device)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {list(VARIANTS)}")
    params = folded["params"]
    k0 = torch.as_tensor(np.ascontiguousarray(np.asarray(
        params["Conv_0"]["kernel"], np.float32).transpose(3, 2, 0, 1)),
        device=device)
    b0 = torch.as_tensor(np.asarray(params["Conv_0"]["bias"], np.float32),
                         device=device)
    packed = pack_folded_params(
        {"params": {f"Conv_{i - 1}": params[f"Conv_{i}"]
                    for i in range(1, len(params))}}, device, compute_dtype)

    def first_layer(x: torch.Tensor) -> torch.Tensor:
        """Conv_0 + ReLU: (B, H, W, Cin) -> the chain's input (B, H, W,
        C1), float32."""
        with exact_fp32():
            act = F.relu(circular_conv2d(
                x.to(torch.float32).permute(0, 3, 1, 2), k0, b0))
        return act.permute(0, 2, 3, 1).contiguous()

    def chain(act: torch.Tensor) -> torch.Tensor:
        if VARIANTS[variant] == "k1":
            return fused_cnn_forward(act, packed)
        return packed_cnn_forward(act, packed)

    def apply(x: torch.Tensor) -> torch.Tensor:
        squeeze = x.ndim == 3
        out = chain(first_layer(x[None] if squeeze else x))
        return out[0] if squeeze else out

    apply.first_layer, apply.packed = first_layer, packed
    return apply
