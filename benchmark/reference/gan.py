"""One training step of the conditional WGAN-GP closure, plain PyTorch,
with two Adams.

Follows Perezhogin, Zanna and Fernandez-Granda (JAMES 2023,
doi:10.1029/2023MS003681, section 3), the Wasserstein GAN with gradient
penalty of Gulrajani et al. (NeurIPS 2017, arXiv:1704.00028) and the drift
term of Karras et al. (ICLR 2018, arXiv:1710.10196), as the paper's
`models/cgan_regression.py` trains its GAN with no mean net:

* generator: an AndrewCNN (`cnn.py`) from (x, z), 2 + 2 channels, to the
  2-channel forcing, in train mode (each call normalises by its batch and
  moves the running statistics);
* critic: the DCGAN discriminator (Radford, Metz and Chintala, ICLR 2016)
  on (x, y1, y2), 6 channels: four 4x4 convolutions at stride 2 with zero
  padding 1 and no bias, 64, 128, 256 and 512 channels, each followed by
  LeakyReLU(0.2), then a valid convolution of kernel nx / 16 to 1 channel;
  no norm and no sigmoid;
* the critic's loss, from two draws of the generator ŷ1 = G(x, z1) and
  ŷ2 = G(x, z2): -0.5 (D(x, y, ŷ2) + D(x, ŷ1, y)) + D(x, ŷ1, ŷ2), each
  averaged over the batch, plus the drift 1e-3 D(x, y, ŷ2)^2 and the
  gradient penalty 10 (|dD/dy'| - 1)^2 at y' = eps ytrue + (1 - eps) yfake,
  eps uniform a sample, the true pair (ŷ1, y) where a fair coin says so,
  else (y, ŷ2), and the fake pair (ŷ1, ŷ2); the penalty's gradient in the
  critic's weights is its double backward (`create_graph=True`);
* the generator's loss -D(x, ŷ1, ŷ2) from two new calls of the generator on
  the same z1 and z2, through the critic as just updated, on every fifth
  batch (n_critic 5);
* Adam (Kingma and Ba) as optax writes it for each net, b1 0.5, b2 0.999,
  eps 1e-8, the learning rate read at that optimizer's own update count,
  piecewise constant: 2e-4, halved at 1/2, 3/4 and 7/8 of the epochs'
  batches.

Departures: the draws (z1, z2, eps and the coin, in that order a batch)
come from one `torch.Generator` on the run's device, and each epoch's rows
from numpy's `default_rng(key).permutation`, the last batch filled from a
draw without replacement, as the benchmark's traffic specifies. The
generator updates on the batches whose index in their epoch is a multiple
of 5. The generator's two calls without gradients before the critic's
update run in train mode too and move its running statistics, as the
paper's code does. The convolutions run as PyTorch's own im2col and GEMMs
(cuDNN off), so that their weight gradients keep float32's precision.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cnn import AndrewCNN, _round

LAMBDA_GP = 10.0
LAMBDA_DRIFT = 1e-3


def schedule(learning_rate: float, num_epochs: int, steps: int):
    bounds = sorted({int(num_epochs * f) * steps for f in (0.5, 0.75, 0.875)})

    def lr(count: int) -> float:
        return learning_rate * 0.5 ** sum(count >= b for b in bounds)
    return lr


def epoch_rows(key: int, n: int, batch_size: int, steps: int) -> np.ndarray:
    """The rows of the first `steps` batches, epoch after epoch: each
    epoch a permutation of the n samples, its last batch filled from a
    draw of the rest without replacement."""
    rng = np.random.default_rng(int(key))
    per_epoch = -(-n // batch_size)
    out = []
    while len(out) < steps:
        perm = rng.permutation(n)
        pad = per_epoch * batch_size - n
        if pad:
            perm = np.concatenate([perm, rng.choice(n, pad, replace=False)])
        out.extend(perm.reshape(per_epoch, batch_size))
    return np.stack(out[:steps])


def draws(gen: torch.Generator, batch: int, nx: int, n_latent: int = 2):
    """(z1, z2, eps, coin) of one batch, NHWC latents."""
    kw = {"generator": gen, "device": gen.device}
    z1 = torch.randn((batch, nx, nx, n_latent), **kw)
    z2 = torch.randn((batch, nx, nx, n_latent), **kw)
    eps = torch.rand((batch, 1, 1, 1), **kw)
    coin = torch.rand((), **kw) < 0.5
    return z1, z2, eps, coin


class _Adam:
    def __init__(self, params: dict, lr, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads) -> None:
        lr = self.lr(self.count)
        t = self.count + 1
        for (name, p), g in zip(params.items(), grads):
            m, v = self.mu[name], self.nu[name]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(lr * (m / (1 - self.b1 ** t))
                   / (torch.sqrt(v / (1 - self.b2 ** t)) + self.eps))
        self.count = t


class WGANGP:
    """The generator from a flax tree, the critic from its flax kernels
    (`{"params": {"Conv_i": {"kernel": HWIO}}}`), each with its Adam, on
    `device`."""

    def __init__(self, g_vars: dict, d_vars: dict, device,
                 learning_rate: float, num_epochs: int, steps: int,
                 b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8):
        self.G = AndrewCNN(g_vars, device, requires_grad=True)
        kernels = d_vars["params"]
        self.D = [torch.tensor(np.transpose(np.asarray(
            kernels[f"Conv_{i}"]["kernel"], np.float32), (3, 2, 0, 1)),
            device=device, requires_grad=True) for i in range(len(kernels))]
        lr = schedule(learning_rate, num_epochs, steps)
        self.opt = {"G": _Adam(self.g_params(), lr, b1, b2, eps),
                    "D": _Adam(self.d_params(), lr, b1, b2, eps)}

    def g_params(self) -> dict:
        return {f"G.{k}": p for k, p in self.G.parameters().items()}

    def d_params(self) -> dict:
        return {f"D.Conv_{i}.kernel": w for i, w in enumerate(self.D)}

    def params(self) -> dict:
        return {**self.g_params(), **self.d_params()}

    def statistics(self) -> dict:
        return {f"G.{k}": s for k, s in self.G.statistics().items()}

    @torch.no_grad()
    def load(self, values: dict, opt: dict) -> None:
        """Every parameter and statistic set to `values` by name, and each
        Adam's moments to `opt[net]` ({"mu", "nu"}): a step taken from
        another's state. The counts are not loaded: each Adam keeps its
        own, advanced by its updates."""
        for k, t in {**self.params(), **self.statistics()}.items():
            t.copy_(values[k])
        for net, adam in self.opt.items():
            for k in adam.mu:
                adam.mu[k].copy_(opt[net]["mu"][k])
                adam.nu[k].copy_(opt[net]["nu"][k])

    def optimizer_state(self) -> dict:
        """Copies of each Adam's count and moments, {net: {"count", "mu",
        "nu"}}."""
        return {net: {"count": adam.count,
                      "mu": {k: v.clone() for k, v in adam.mu.items()},
                      "nu": {k: v.clone() for k, v in adam.nu.items()}}
                for net, adam in self.opt.items()}

    def critic(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        """(B, 6, nx, nx) -> (B, 1)."""
        last = len(self.D) - 1
        for i, w in enumerate(self.D):
            x = F.conv2d(_round(x, mode), _round(w, mode),
                         stride=1 if i == last else 2,
                         padding=0 if i == last else 1)
            if i < last:
                x = F.leaky_relu(x, 0.2)
        return x.reshape(x.shape[0], -1)[:, :1]

    def penalty(self, x, ytrue, yfake, eps, mode: str,
                double_backward: bool = True) -> torch.Tensor:
        """The gradient penalty; with `double_backward=False` (a fault, for
        calibration) its input gradient is taken without a graph, so that
        the critic's update does not see it."""
        yi = (eps * ytrue + (1 - eps) * yfake).requires_grad_(True)
        d, = torch.autograd.grad(
            self.critic(torch.cat([x, yi], 1), mode).sum(), yi,
            create_graph=double_backward)
        norms = torch.sqrt((d.reshape(d.shape[0], -1) ** 2).sum(-1) + 1e-12)
        return LAMBDA_GP * ((norms - 1.0) ** 2).mean()

    def step(self, x, y, batch_draws, generator: bool, mode: str = "float32",
             double_backward: bool = True, update_generator: bool = True):
        """One batch of x, y (B, 2, nx, nx) with `batch_draws` (`draws`):
        the critic's update and, where `generator`, the generator's. Returns
        ({D_loss, D_grad, D_drift, G_loss}, {"D": gradients, "G": gradients
        or None}), G_loss 0 on a critic-only batch. `update_generator=False`
        (a fault, for calibration) leaves the generator's update out."""
        z1, z2, eps, coin = batch_draws
        z1, z2 = z1.permute(0, 3, 1, 2), z2.permute(0, 3, 1, 2)
        with torch.no_grad():
            yf1 = self.G(torch.cat([x, z1], 1), train=True, mode=mode)
            yf2 = self.G(torch.cat([x, z2], 1), train=True, mode=mode)
        d_true1 = self.critic(torch.cat([x, y, yf2], 1), mode)
        d_true2 = self.critic(torch.cat([x, yf1, y], 1), mode)
        d_fake = self.critic(torch.cat([x, yf1, yf2], 1), mode)
        d_loss = -0.5 * (d_true1.mean() + d_true2.mean()) + d_fake.mean()
        drift = LAMBDA_DRIFT * (d_true1 ** 2).mean()
        ytrue = torch.where(coin, torch.cat([yf1, y], 1),
                            torch.cat([y, yf2], 1))
        gp = self.penalty(x, ytrue, torch.cat([yf1, yf2], 1), eps, mode,
                          double_backward)
        pd = self.d_params()
        gd = torch.autograd.grad(d_loss + gp + drift, list(pd.values()))
        self.opt["D"].update(pd, gd)
        terms = {"D_loss": d_loss, "D_grad": gp, "D_drift": drift,
                 "G_loss": torch.zeros((), device=x.device)}
        grads = {"D": dict(zip(pd, gd)), "G": None}
        if generator and update_generator:
            yg1 = self.G(torch.cat([x, z1], 1), train=True, mode=mode)
            yg2 = self.G(torch.cat([x, z2], 1), train=True, mode=mode)
            g_loss = -self.critic(torch.cat([x, yg1, yg2], 1), mode).mean()
            pg = self.g_params()
            gg = torch.autograd.grad(g_loss, list(pg.values()))
            self.opt["G"].update(pg, gg)
            terms["G_loss"] = g_loss
            grads["G"] = dict(zip(pg, gg))
        return {k: float(v.detach()) for k, v in terms.items()}, grads
