"""The closures' networks as PyTorch modules, and the BatchNorm folding.

Twin of `pyqg_generative_tpu/ml/nets.py`: `AndrewCNN` (the 8-layer circular
CNN, kernels [5,5,3x6], channels [128,64,32x5], conv -> ReLU -> BatchNorm after
each hidden conv, with the `div=True` spectral-divergence head), `VarCNN`, the
stencil MLP `ANN`, `ResUnit` and the U-Net `DeepInversionGenerator`, and the
bottleneck VAE's `Downsampling` and `Upsampling`, and the GAN's critic
`DCGANDiscriminator`. The modules compute in PyTorch's NCHW but take and return
NHWC (a flat (B, features) for the dense ends), the twin's layout, so that the
two compare like with like.

Every submodule carries its flax name (`Conv_0`, `BatchNorm_3`,
`ConvTranspose_1`, `Dense_0`, `ResUnit_5`), so that a state dict's keys are
the flax tree's paths and `ml.weights.params_from_jax` / `params_to_jax`
carry weights across by name alone. flax's padding conventions:
`padding="CIRCULAR"` wraps (k-1)//2 and k//2 cells and convolves "valid"
(also at stride 2); `ConvTranspose` with the default `transpose_kernel=False`
is `conv_transpose2d` on the kernel flipped in both spatial axes, with no
padding, cropped to stride x the input ("SAME" output size).

Training (twin :25-41): `BatchNorm` in train mode is flax's (the biased
batch variance normalises and enters the running average, 0.9 old + 0.1
new), and `init_weights` draws a module's weights by the twin's
initializers from an explicit `torch.Generator`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..qg.grid import make_grid

__all__ = ["AndrewCNN", "VarCNN", "ANN", "ResUnit", "DeepInversionGenerator",
           "Downsampling", "Upsampling", "DCGANDiscriminator", "BatchNorm",
           "fold_batchnorm", "circular_conv2d", "spectral_divergence",
           "divergence_head", "dcgan_normal_init", "init_weights",
           "count_params"]

HIDDEN = (128, 64, 32, 32, 32, 32, 32)
BN_EPS = 1e-5  # flax BatchNorm's epsilon in the twin (`_norm`)
BN_MOMENTUM = 0.9  # flax's: running = 0.9 running + (1 - 0.9) batch
# flax's truncated normal draws N(0, 1) cut at +-2 and divides by this, the
# standard deviation of the cut distribution, so its variance is the target
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5) whose train-mode forward is flax's
    `BatchNorm(momentum=0.9, use_fast_variance=False)`: mean and biased
    variance over (N, H, W), y = (x - mean) * (rsqrt(var + eps) * scale) +
    bias, and the running statistics 0.9 old + (1 - 0.9) batch, the
    variance biased (torch's own would enter the unbiased one);
    `num_batches_tracked`, which flax does not keep, stays 0. Eval mode is
    torch's, on the running statistics."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


def dcgan_normal_init(std: float = 0.02):
    """N(0, std^2) kernel initializer (the DCGAN recipe; reference
    tools/cnn_tools.py:54-65): init(tensor, generator) fills in place."""
    def init(tensor: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            tensor.normal_(0.0, std, generator=generator)
    return init


def _lecun_normal(tensor: torch.Tensor, generator: torch.Generator,
                  fan_in: int):
    """flax's default kernel initializer `lecun_normal`: a truncated normal
    of variance 1/fan_in."""
    with torch.no_grad():
        nn.init.trunc_normal_(tensor, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        tensor.mul_(np.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _fan_in(layer: nn.Module) -> int:
    """The flax kernel's fan-in: (kh, kw, in) of a (transposed) conv, in of
    a dense layer."""
    w = layer.weight
    if isinstance(layer, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return int(np.prod(w.shape[1:]))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw `module`'s weights from `generator` by the twin's initializers,
    layer by layer in registration order: a conv of an AndrewCNN or of the
    critic N(0, 0.02) (`dcgan_normal_init`), every other conv, transposed
    conv and dense kernel flax's `lecun_normal`, biases zero; a BatchNorm's
    scale N(0, 0.02), its bias zero, its running mean 0 and variance 1
    (`_norm` :31-41)."""
    for parent in module.modules():
        dcgan = getattr(parent, "kernel_init", None) == "dcgan"
        for layer in parent.children():
            if isinstance(layer, BatchNorm):
                dcgan_normal_init()(layer.weight, generator)
                with torch.no_grad():
                    layer.bias.zero_()
                layer.reset_running_stats()
            elif isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d,
                                    nn.Linear)):
                if dcgan:
                    dcgan_normal_init()(layer.weight, generator)
                else:
                    _lecun_normal(layer.weight, generator, _fan_in(layer))
                if layer.bias is not None:
                    with torch.no_grad():
                        layer.bias.zero_()


def count_params(module: nn.Module) -> int:
    """Parameters and BatchNorm statistics: the size of the twin's
    variables tree (`count_params` :349)."""
    return sum(int(t.numel()) for k, t in module.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def circular_conv2d(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None,
                    stride: int = 1) -> torch.Tensor:
    """Circular convolution of NCHW `x` with an OIHW kernel (flax
    `padding="CIRCULAR"`): (k-1)//2 cells wrapped before, k//2 after, then a
    valid convolution at `stride`."""
    k = w.shape[-1]
    lo, hi = (k - 1) // 2, k // 2
    if k > 1:
        x = F.pad(x, (lo, hi, lo, hi), mode="circular")
    return F.conv2d(x, w, b, stride=stride)


def _conv_transpose_same(x: torch.Tensor, layer: nn.ConvTranspose2d,
                         stride: int) -> torch.Tensor:
    """flax `ConvTranspose(strides=stride, padding="SAME")` on NCHW x: the
    torch transposed convolution (whose weight holds the flax kernel
    flipped), cropped to stride x the input."""
    H, W = x.shape[-2] * stride, x.shape[-1] * stride
    y = F.conv_transpose2d(x, layer.weight, layer.bias, stride=stride)
    return y[..., :H, :W]


@lru_cache(maxsize=16)
def _divergence_consts(ny: int, nx: int, device: torch.device,
                       dtype: torch.dtype):
    """(ik, il) of the L = 1e6 m grid as complex tensors on `device`, built
    once per shape: a captured step copies no array to the card."""
    g = make_grid(nx, ny, L=1e6)
    return (torch.as_tensor(g.ik, dtype=dtype, device=device),
            torch.as_tensor(g.il, dtype=dtype, device=device))


def spectral_divergence(x: torch.Tensor) -> torch.Tensor:
    """NHWC (..., ny, nx, 2C) -> (..., ny, nx, C): d/dx of the first C
    channels plus d/dy of the last C, by rFFT, on the reference L = 1e6 m
    domain whatever the run's L (the twin's `spectral_divergence`)."""
    ny, nx, c = x.shape[-3], x.shape[-2], x.shape[-1] // 2
    xh = torch.fft.rfftn(x.movedim(-1, -3), dim=(-2, -1))
    ik, il = _divergence_consts(ny, nx, x.device, xh.dtype)
    div_h = xh[..., :c, :, :] * ik + xh[..., c:, :, :] * il
    div = torch.fft.irfftn(div_h, s=(ny, nx), dim=(-2, -1))
    return div.movedim(-3, -1)


def divergence_head(y: torch.Tensor) -> torch.Tensor:
    """The `div=True` head: 10000 * spectral divergence, in float32."""
    return 10000.0 * spectral_divergence(y.to(torch.float32))


def _activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """flax's activation of that name (`relu`, `softplus`, ...)."""
    return getattr(F, name.lower())(x)


class AndrewCNN(nn.Module):
    """8-layer circular CNN, ReLU + BatchNorm after each hidden conv
    (reference tools/cnn_tools.py:125-182). Eval-mode BatchNorm uses the
    running statistics, as the twin does with `train=False`. `div=True`
    doubles the output channels and returns 10000 * their spectral
    divergence, n_out channels. Its convs are drawn N(0, 0.02)."""

    kernel_init = "dcgan"

    def __init__(self, n_in: int, n_out: int,
                 hidden_channels: Sequence[int] = HIDDEN,
                 kernels: Sequence[int] = (5, 5, 3, 3, 3, 3, 3, 3),
                 batch_norm: bool = True, bias: bool = True,
                 relu: str = "ReLU", final_activation: str = "None",
                 div: bool = False):
        super().__init__()
        if any(k % 2 == 0 for k in kernels):
            raise ValueError("circular 'same' convolutions need odd kernels")
        chans = list(hidden_channels) + [2 * n_out if div else n_out]
        cins = [n_in] + chans[:-1]
        self.n_layers = len(list(zip(chans, kernels)))
        for i, (ci, co, k) in enumerate(zip(cins, chans, kernels)):
            self.add_module(f"Conv_{i}", nn.Conv2d(ci, co, k, bias=bias))
            if batch_norm and i < self.n_layers - 1:
                self.add_module(f"BatchNorm_{i}",
                                BatchNorm(co))
        self.batch_norm = batch_norm
        self.relu = relu
        self.final_activation = final_activation
        self.div = div

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC -> (B, H, W, n_out)."""
        x = x.permute(0, 3, 1, 2)
        last = self.n_layers - 1
        for i in range(self.n_layers):
            conv = getattr(self, f"Conv_{i}")
            x = circular_conv2d(x, conv.weight, conv.bias)
            if i < last:
                x = F.relu(x) if self.relu == "ReLU" \
                    else F.leaky_relu(x, 0.2)
                if self.batch_norm:
                    x = getattr(self, f"BatchNorm_{i}")(x)
        if self.final_activation != "None":
            x = _activation(x, self.final_activation)
        x = x.permute(0, 2, 3, 1)
        return divergence_head(x) if self.div else x


def VarCNN(n_in: int, n_out: int, **kw) -> AndrewCNN:
    """AndrewCNN with a softplus head: the nonnegative pointwise conditional
    variance of the GZ closure."""
    kw.setdefault("final_activation", "softplus")
    return AndrewCNN(n_in, n_out, **kw)


class ANN(nn.Module):
    """Pointwise MLP on flattened stencils (..., n_in) -> (..., n_out), ReLU
    between the dense layers; with `degree`, the scale-invariant form
    norm(x)^degree * f(x / norm(x)) (reference tools/cnn_tools.py:184-210).
    """

    def __init__(self, n_in: int, n_out: int,
                 hidden_channels: Sequence[int] = (24, 24),
                 degree: float | None = None):
        super().__init__()
        widths = [n_in] + list(hidden_channels) + [n_out]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i],
                                                    widths[i + 1]))
        self.degree = degree

    def _mlp(self, z: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            z = getattr(self, f"Dense_{i}")(z)
            if i < self.n_layers - 1:
                z = F.relu(z)
        return z

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.degree is None:
            return self._mlp(x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        safe = torch.where(norm == 0, torch.ones_like(norm), norm)
        return safe ** self.degree * self._mlp(x / safe)


class ResUnit(nn.Module):
    """Residual unit with circular 3x3 convs on NCHW:
    y = norm(x); out = (leaky -> conv -> norm -> leaky -> conv)(y) +
    conv1x1(y) (reference tools/deep_inversion.py:104-124); `bn` is
    "BatchNorm" or "None"."""

    def __init__(self, in_ch: int, out_ch: int, bn: str = "BatchNorm"):
        super().__init__()
        if bn not in ("BatchNorm", "None"):
            raise ValueError(f"norm {bn!r}: 'BatchNorm' or 'None'")
        self.bn = bn
        if bn == "BatchNorm":
            self.BatchNorm_0 = BatchNorm(in_ch)
            self.BatchNorm_1 = BatchNorm(out_ch)
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3)
        self.Conv_1 = nn.Conv2d(out_ch, out_ch, 3)
        self.Conv_2 = nn.Conv2d(in_ch, out_ch, 1)

    def _norm(self, i: int, z: torch.Tensor) -> torch.Tensor:
        return z if self.bn == "None" else getattr(self, f"BatchNorm_{i}")(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._norm(0, x)
        h = circular_conv2d(F.leaky_relu(y, 0.2), self.Conv_0.weight,
                            self.Conv_0.bias)
        h = F.leaky_relu(self._norm(1, h), 0.2)
        h = circular_conv2d(h, self.Conv_1.weight, self.Conv_1.bias)
        return h + self.Conv_2(y)


class DeepInversionGenerator(nn.Module):
    """U-Net generator (arXiv 1811.05910 fig. 8): circular residual units,
    2x2 average pooling down to 1/16 of the grid, 2x2 stride-2 transposed
    convs up with skip concatenation (reference
    tools/deep_inversion.py:44-101). NHWC in and out."""

    DOWN = (64, 128, 256, 512)

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(n_in, 32, 3)
        units = [(32, 32, "None")]
        ch = 32
        for w in self.DOWN:
            units.append((ch, w, "BatchNorm"))
            ch = w
        units.append((512, 512, "BatchNorm"))
        for i, w in enumerate((256, 128, 64, 32)):
            self.add_module(f"ConvTranspose_{i}",
                            nn.ConvTranspose2d(ch, ch // 2, 2, stride=2))
            units.append((ch // 2 + w, w, "BatchNorm"))
            ch = w
        units.append((32, 32, "None"))
        for i, (ci, co, bn) in enumerate(units):
            self.add_module(f"ResUnit_{i}", ResUnit(ci, co, bn))
        self.Conv_1 = nn.Conv2d(32, n_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = circular_conv2d(x, self.Conv_0.weight, self.Conv_0.bias)
        skips = [self.ResUnit_0(x)]
        for i in range(1, 5):
            skips.append(getattr(self, f"ResUnit_{i}")(
                F.avg_pool2d(skips[-1], 2)))
        h = self.ResUnit_5(skips.pop())
        for i in range(4):
            h = _conv_transpose_same(h, getattr(self, f"ConvTranspose_{i}"),
                                     2)
            h = getattr(self, f"ResUnit_{6 + i}")(
                torch.cat([h, skips.pop()], dim=1))
        h = self.ResUnit_10(h)
        return self.Conv_1(h).permute(0, 2, 3, 1)


class Downsampling(nn.Module):
    """Stride-2 circular 3x3 convs, each with BatchNorm and LeakyReLU(0.01),
    then (`flatten`) a dense head on the map flattened in NHWC order
    (reference tools/cnn_tools.py:246-279): (B, nx, nx, n_in) -> (B, n_out)
    or, unflattened, (B, nx/2^n_down, ..., n_out). The bottleneck VAE's
    encoder."""

    def __init__(self, n_in: int, n_down: int, n_out: int, nx: int = 64,
                 hidden_dims: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 flatten: bool = True):
        super().__init__()
        self.n_down, self.flatten = n_down, flatten
        ch = n_in
        for i in range(n_down):
            nout = n_out if (i == n_down - 1 and not flatten) \
                else hidden_dims[i]
            self.add_module(f"Conv_{i}", nn.Conv2d(ch, nout, 3))
            self.add_module(f"BatchNorm_{i}", BatchNorm(nout))
            ch = nout
        if flatten:
            nxc = nx // 2 ** n_down
            self.Dense_0 = nn.Linear(ch * nxc * nxc, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_down):
            conv = getattr(self, f"Conv_{i}")
            x = circular_conv2d(x, conv.weight, conv.bias, stride=2)
            x = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(x), 0.01)
        x = x.permute(0, 2, 3, 1)
        if self.flatten:
            x = self.Dense_0(x.reshape(x.shape[0], -1))
        return x


class Upsampling(nn.Module):
    """(`flatten`) a dense layer from a flat latent (B, n_in) unflattened in
    NHWC order to (B, nx/2^n_up, ..., C), then stride-2 3x3 transposed convs
    ("SAME"), each with BatchNorm and LeakyReLU(0.01) (reference
    tools/cnn_tools.py:281-319): -> (B, nx, nx, n_out). The bottleneck VAE's
    deep decoder."""

    def __init__(self, n_in: int, n_up: int, n_out: int, nx: int = 64,
                 hidden_dims: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 flatten: bool = True):
        super().__init__()
        hd = list(hidden_dims[:n_up])[::-1]
        self.n_up, self.flatten, self.nxc, self.hd0 = n_up, flatten, \
            nx // 2 ** n_up, hd[0]
        if flatten:
            self.Dense_0 = nn.Linear(n_in, hd[0] * self.nxc * self.nxc)
        ch = hd[0] if flatten else n_in
        for i in range(n_up):
            nout = n_out if i == n_up - 1 else hd[i + 1] \
                if i + 1 < len(hd) else n_out
            self.add_module(f"ConvTranspose_{i}",
                            nn.ConvTranspose2d(ch, nout, 3, stride=2))
            self.add_module(f"BatchNorm_{i}", BatchNorm(nout))
            ch = nout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.flatten:
            x = self.Dense_0(x).reshape(x.shape[0], self.nxc, self.nxc,
                                        self.hd0)
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_up):
            x = _conv_transpose_same(
                x, getattr(self, f"ConvTranspose_{i}"), 2)
            x = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(x), 0.01)
        return x.permute(0, 2, 3, 1)



class DCGANDiscriminator(nn.Module):
    """The GAN's critic (twin :131-158; reference tools/cnn_tools.py:212-244):
    four stride-2 4x4 convs with zero padding 1 and no bias, each followed
    by LeakyReLU(0.2), then a valid conv of kernel nx/64*4 that collapses
    the nx/16 map to 1x1; no sigmoid. NHWC (B, nx, nx, n_in) -> (B, 1), the
    first entry of the flattened map, as the twin's `[:, :1]`. The GAN
    closure's critic has no norm layers (bn="None", the only one here);
    its convs are drawn N(0, 0.02)."""

    kernel_init = "dcgan"

    def __init__(self, n_in: int = 6, ndf: int = 64, nx: int = 64,
                 bn: str = "None"):
        super().__init__()
        if bn != "None":
            raise ValueError(f"critic norm {bn!r}: only 'None' is ported")
        ch = n_in
        for i, w in enumerate((ndf, ndf * 2, ndf * 4, ndf * 8)):
            self.add_module(f"Conv_{i}", nn.Conv2d(ch, w, 4, stride=2,
                                                   padding=1, bias=False))
            ch = w
        kfin = int(nx / 64 * 4)
        self.Conv_4 = nn.Conv2d(ch, 1, kfin, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"Conv_{i}")(x), 0.2)
        x = self.Conv_4(x).permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)[:, :1]


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def fold_batchnorm(variables: dict, eps: float = BN_EPS) -> dict:
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
