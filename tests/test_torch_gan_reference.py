"""The port's GAN training step (`cgan_regression.GanTrainer`) against the
benchmark's plain reference (`benchmark/reference/gan.py`, plain PyTorch
in float32, which imports nothing of the port) on the CPU at 16^2: the
same seeded random weights, rows and draws, 11 steps, the generator
updated on steps 0, 5 and 10 (5 batches an epoch, so two epochs' ends):
the losses of every step, both nets' first gradients, and their parameters
and the generator's BatchNorm statistics after the steps compared.

Both sides compute in float32 with the same convolutions (PyTorch's own on
the CPU) in different layouts: the port's nets take NHWC, the reference's
NCHW, so the penalty's norms and the BatchNorms' means sum in another
order. So the two agree to float32's rounding at first, and the
tolerances below say how far that rounding may grow."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml.weights import params_from_jax
from pyqg_generative_torch.models import CGANRegression
from pyqg_generative_torch.models.cgan_regression import GanTrainer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import inputs  # noqa: E402
from benchmark.drivers.gan_training import critic_variables  # noqa: E402
from benchmark.reference import precision  # noqa: E402
from benchmark.reference.gan import WGANGP, draws, epoch_rows  # noqa: E402

torch.set_num_threads(1)

NX, B, N, STEPS = 16, 8, 40, 11
HIDDEN = (32, 16, 8, 8, 8, 8, 8)
NDF = 8


def _ref_name(net: str, name: str) -> str:
    layer, attr = name.rsplit(".", 1)
    attr = {"weight": "kernel" if layer.startswith("Conv") else "scale",
            "running_mean": "mean", "running_var": "var"}.get(attr, attr)
    return f"{net}.{layer}.{attr}"


def _run(seed: int):
    """(port's per-step metrics, its first gradients, its state after the
    steps; the reference's three) from one seed's weights, data and key."""
    gen = torch.Generator().manual_seed(seed)
    trees = {"G": inputs.andrew_variables(gen, 4, 2, HIDDEN),
             "D": critic_variables(gen, NX, NDF)}
    X, Y = (torch.randn(N, NX, NX, 2, generator=gen) for _ in range(2))
    key = seed + 1000

    net = CGANRegression(folder="/nonexistent_model_folder", device="cpu",
                         nx=NX, hidden_channels=HIDDEN)
    net.D = tnets.DCGANDiscriminator(6, ndf=NDF, nx=NX)
    net._set_generator(trees["G"])
    net.D.load_state_dict(params_from_jax(trees["D"]))
    net.vars_D = trees["D"]
    trainer = GanTrainer(net, (X, Y, torch.zeros_like(Y)), 2, B, 2e-4, key)
    terms, first, perm, i = [], None, trainer.batches(), 0
    for _ in range(STEPS):
        if i == len(perm):
            perm, i = trainer.batches(), 0
        terms.append({k: float(v) for k, v in
                      trainer.step(i, perm[i]).items()})
        i += 1
        if first is None:
            first = {_ref_name(n, k): v / 0.5 for n in "GD"
                     for k, v in trainer.opt[n]["mu"].items()}
    state = {_ref_name(n, k): v.detach().clone() for n in "GD"
             for k, v in getattr(net, n).state_dict().items()
             if not k.endswith("num_batches_tracked")}

    ref = WGANGP(trees["G"], trees["D"], "cpu", 2e-4, 2, N // B)
    rows = torch.as_tensor(epoch_rows(key, N, B, STEPS))
    rgen = torch.Generator().manual_seed(key)
    ref_terms, ref_first = [], None
    with precision("float32", cudnn=False):
        for s in range(STEPS):
            x = X[rows[s]].permute(0, 3, 1, 2)
            y = Y[rows[s]].permute(0, 3, 1, 2)
            t, grads = ref.step(x, y, draws(rgen, B, NX), s % 5 == 0)
            ref_terms.append(t)
            ref_first = ref_first or {**grads["D"], **grads["G"]}
    ref_state = {k: v.detach() for k, v in
                 {**ref.params(), **ref.statistics()}.items()}
    return (terms, first, state), (ref_terms, ref_first, ref_state)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The L2 norm of the difference over the reference's."""
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_gan_steps_follow_the_plain_reference(seed):
    """Tolerances, each with its reason (readings over 8 seeds in
    brackets):

    * the first step (a generator batch) runs from equal states, so its
      losses and both nets' first gradients differ by the layouts'
      summation order alone: each loss within 1e-4 of the reference's (the
      critic's and the generator's losses are means of outputs of both
      signs, so a rounding can be a larger share of them; up to 1.6e-5),
      each leaf of the gradients within 1e-5 in relative L2 (2.4e-6);
    * later steps start from states that differ by that rounding, and Adam
      turns a gradient element's last-bit difference into a whole update
      of the other sign, so the losses drift: each of the 11 steps' losses
      within 1e-3 (1.7e-4);
    * after 11 steps each parameter leaf of both nets and each BatchNorm
      statistic within 1e-4 in relative L2 of the reference's (4.2e-6):
      the updates move each element by about the learning rate, 1% of a
      weight of 0.02, and a flipped update of a few elements moves a leaf
      of hundreds by a small share of that;
    * each step's generator loss is 0 exactly on the critic-only batches,
      on both sides."""
    (terms, first, state), (ref_terms, ref_first, ref_state) = _run(seed)
    for k in terms[0]:
        assert terms[0][k] == pytest.approx(ref_terms[0][k], rel=1e-4), k
    assert first.keys() == ref_first.keys()
    for k in first:
        assert _rel(first[k], ref_first[k]) <= 1e-5, k
    for s, (a, b) in enumerate(zip(terms, ref_terms)):
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-3), (s, k)
        assert (a["G_loss"] == 0) == (b["G_loss"] == 0) == (s % 5 != 0)
    assert state.keys() == ref_state.keys()
    gaps = {k: _rel(state[k], ref_state[k]) for k in state}
    assert max(gaps.values()) <= 1e-4, max(gaps, key=gaps.get)
    assert np.isfinite(list(gaps.values())).all()
