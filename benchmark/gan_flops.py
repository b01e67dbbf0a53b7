"""Operations of the conditional WGAN-GP closure's training step, from the
configuration's widths: `yardstick.py`'s rule for a convolution (a K x K
convolution from cin to cout channels costs 2 K^2 cin cout for each pixel
of its output), applied pass by pass.

A pass of a convolution costs what its forward costs: the forward F, the
input's gradient F, the weights' gradient F. A critic-only batch, a
sample:

* the generator's two calls without gradients: 2 F_G;
* the critic's three calls on (x, y, ŷ2), (x, ŷ1, y), (x, ŷ1, ŷ2): 3 F_D,
  and their backward to the critic's weights: the weights' gradient of
  every layer and the input's gradient of every layer but the first, whose
  input is data: 3 (2 F_D - F_D0);
* the gradient penalty: the critic's call on the interpolate, F_D, and its
  input's gradient through every layer, F_D; its double backward, which
  differentiates each layer's input gradient (a convolution of the layer's
  output gradient with its weights) once in the weights (F_D) and once in
  the output gradient, which carries the weights of the layers above (F_D
  less the last layer, whose output gradient is the constant 1 of the
  sum). LeakyReLU's derivative is piecewise constant, so its gradient in
  the critic's activations is zero; autograd carries that zero gradient
  back through the call on the interpolate all the same, a whole backward
  to the weights (2 F_D - F_D0), which the card runs and which is counted.

So a critic-only batch costs 2 F_G + 15 F_D - 4 F_D0 - F_D4 a sample. A
generator batch adds the generator's two calls with gradients, 2 F_G, the
critic's call on their output, F_D, its input's gradient through every
layer, F_D (the critic's weights take no gradient here), and the
generator's backward: the weights' gradient of every layer and the input's
gradient of every layer but the first: 2 (2 F_G - F_G0). The BatchNorms,
activations, the losses and Adam are elementwise and not counted. At 64^2
with the paper's widths a period of 5 batches averages 10.4 GFLOP a
sample.
"""
from __future__ import annotations

from typing import Sequence

from .yardstick import andrew_layers, layers_flops


def critic_layer_flops(nx: int, ndf: int = 64, n_in: int = 6) -> list:
    """Forward operations of one image through each critic convolution:
    four 4x4 at stride 2 (ndf, 2 ndf, 4 ndf, 8 ndf channels), then the
    valid one of kernel nx / 16 to 1 channel."""
    chans = [n_in, ndf, 2 * ndf, 4 * ndf, 8 * ndf]
    out, h = [], nx
    for i in range(4):
        h //= 2
        out.append(2.0 * 16 * chans[i] * chans[i + 1] * h * h)
    k = int(nx / 64 * 4)
    h = h - k + 1
    out.append(2.0 * k * k * chans[4] * h * h)
    return out


def gan_train_flops_per_sample(hidden: Sequence[int], nx: int,
                               generator_share: float, ndf: int = 64,
                               n_latent: int = 2) -> float:
    """Operations of one sample of a training batch, where a share
    `generator_share` of the batches update the generator too (1/5 on the
    paper's schedule), by the module's rule."""
    g_layers = andrew_layers(2 + n_latent, 2, hidden)
    f_g = layers_flops(g_layers, nx, nx)
    f_g0 = layers_flops(g_layers[:1], nx, nx)
    d = critic_layer_flops(nx, ndf)
    f_d = sum(d)
    critic = 2 * f_g + 15 * f_d - 4 * d[0] - d[-1]
    generator = 2 * f_g + 2 * f_d + 2 * (2 * f_g - f_g0)
    return critic + generator_share * generator
