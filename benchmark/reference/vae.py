"""One training step of the sigma-VAE closure, plain PyTorch, with Adam.

Follows Perezhogin, Zanna and Fernandez-Granda (JAMES 2023,
doi:10.1029/2023MS003681, section 3.3) and the sigma-VAE of Rybkin, Daniilidis
and Levine (ICML 2021, "Simple and effective VAE training with calibrated
decoders"), as their `models/cvae_regression.py` trains it with
`decoder_var="adaptive"` and no mean net:

* encoder: an AndrewCNN from (x, y), 4 channels, to per-pixel (mu, logvar)
  of a 2-channel latent; decoder: an AndrewCNN from (x, z), z = mu + eps
  exp(logvar / 2), to the 2-channel forcing; both in train mode;
* loss = sum over pixels of (yhat - y)^2 / (2 var_p) + sum over pixels of
  KL(N(mu, var) || N(0, 1)), each averaged over the batch; var_p is the
  batch's mean squared error, held fixed for the gradient (the adaptive
  sigma-VAE);
* Adam (Kingma and Ba) as optax writes it, b1 0.9, b2 0.999, eps 1e-8, the
  learning rate read at the update count before the update, piecewise
  constant: 2e-4, times 0.1 at 1/2, 3/4 and 7/8 of the epochs' batches.

Departures: the latent's draw eps comes from a `torch.Generator` on the
run's device, one draw a step, and the batches' rows from numpy's
`default_rng(key).permutation`, as the benchmark's traffic specifies. The
convolutions run as PyTorch's own im2col and GEMMs (cuDNN off), so that
their weight gradients keep float32's precision.
"""
from __future__ import annotations

import numpy as np
import torch

from .cnn import AndrewCNN


def schedule(learning_rate: float, num_epochs: int, steps: int):
    bounds = sorted({int(num_epochs * f) * steps for f in (0.5, 0.75, 0.875)})

    def lr(count: int) -> float:
        return learning_rate * 0.1 ** sum(count >= b for b in bounds)
    return lr


def batch_rows(key: int, n: int, batch_size: int, steps: int) -> np.ndarray:
    """The first `steps` batches' rows of the first epoch."""
    perm = np.random.default_rng(int(key)).permutation(n)
    return perm[:steps * batch_size].reshape(steps, batch_size)


class SigmaVAE:
    """Encoder and decoder from flax trees, Adam's state, on `device`."""

    def __init__(self, enc_vars: dict, dec_vars: dict, device,
                 learning_rate: float, num_epochs: int, steps: int,
                 n_latent: int = 2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.enc = AndrewCNN(enc_vars, device, requires_grad=True)
        self.dec = AndrewCNN(dec_vars, device, requires_grad=True)
        self.n_latent = n_latent
        self.lr = schedule(learning_rate, num_epochs, steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params().items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params().items()}

    def params(self) -> dict:
        return {**{f"enc.{k}": p for k, p in self.enc.parameters().items()},
                **{f"dec.{k}": p for k, p in self.dec.parameters().items()}}

    def statistics(self) -> dict:
        return {**{f"enc.{k}": s for k, s in self.enc.statistics().items()},
                **{f"dec.{k}": s for k, s in self.dec.statistics().items()}}

    def loss(self, x, y, eps, mode: str):
        """(loss, {MSE, loss_KL}) of x, y (B, 2, ny, nx) and eps (B,
        n_latent, ny, nx)."""
        out = self.enc(torch.cat([x, y], dim=1), train=True, mode=mode)
        mu, logvar = out[:, :self.n_latent], out[:, self.n_latent:]
        var = torch.exp(logvar)
        z = mu + eps * torch.exp(0.5 * logvar)
        yhat = self.dec(torch.cat([x, z], dim=1), train=True, mode=mode)
        b = x.shape[0]
        se = (yhat - y) ** 2
        var_p = se.mean().detach()
        recon = se.reshape(b, -1).sum(-1).mean() / (2.0 * var_p)
        kl = (0.5 * (mu ** 2 + var - 1.0 - logvar)).reshape(b, -1).sum(-1)
        kl = kl.mean()
        return recon + kl, {"MSE": var_p, "loss_KL": kl.detach()}

    def step(self, x, y, eps, mode: str = "float32"):
        """One update; returns ({loss, MSE, loss_KL}, {name: gradient})."""
        params = self.params()
        loss, terms = self.loss(x, y, eps, mode)
        grads = torch.autograd.grad(loss, list(params.values()))
        lr = self.lr(self.count)
        t = self.count + 1
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                m, v = self.mu[name], self.nu[name]
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                p.sub_(lr * (m / (1 - self.b1 ** t))
                       / (torch.sqrt(v / (1 - self.b2 ** t)) + self.eps))
        self.count = t
        terms = {"loss": loss.detach(), **terms}
        return {k: float(v) for k, v in terms.items()}, dict(zip(params, grads))
