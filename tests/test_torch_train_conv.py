"""The split training convolution (`ml/train_conv.py`): cuDNN's input
gradient where its shape allows, PyTorch's own forward, weight and bias
gradients, behind `AndrewCNN` in training.

On the CPU: gradcheck in float64, equality with `nn.Conv2d`'s circular
autograd, the `train_conv.split_backward` counter (one a conv a backward,
only in training), and a double backward that raises. On the card (imports
no jax): python -m pytest tests/test_torch_train_conv.py -m cuda
--noconftest
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from pyqg_generative_torch.device import exact_fp32_training
from pyqg_generative_torch.ml import nets
from pyqg_generative_torch.ml.nets import AndrewCNN, DCGANDiscriminator
from pyqg_generative_torch.ml.train_conv import cudnn_input_grad, \
    split_conv2d
from pyqg_generative_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

SPLIT = "train_conv.split_backward"


def _circular(x, k):
    lo = (k - 1) // 2
    return F.pad(x, (lo, k // 2, lo, k // 2), mode="circular")


def _small_net(n_in=3, n_out=2):
    torch.manual_seed(0)
    return AndrewCNN(n_in, n_out, hidden_channels=(6, 5, 4, 4, 4, 4, 4)
                     ).double()


def _splits():
    return profiling.counters().get(SPLIT, 0)


@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("input_grad", [True, False])
def test_gradcheck(k, bias, input_grad):
    g = torch.Generator().manual_seed(k)
    x = torch.randn((2, 3, 6, 7), generator=g, dtype=torch.float64,
                    requires_grad=input_grad)
    w = torch.randn((4, 3, k, k), generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(4, generator=g, dtype=torch.float64,
                    requires_grad=True) if bias else None
    args = (x, w) + ((b,) if bias else ())
    assert torch.autograd.gradcheck(
        lambda x, w, *b: split_conv2d(_circular(x, k), w, *b), args)


@pytest.mark.parametrize("k", [5, 3])
def test_equals_circular_conv2d_autograd(k):
    """Output and every gradient as `nn.Conv2d(padding_mode="circular")`
    computes them, in float64."""
    torch.manual_seed(k)
    conv = nn.Conv2d(3, 5, k, padding=(k - 1) // 2,
                     padding_mode="circular").double()
    x = torch.randn((2, 3, 9, 8), dtype=torch.float64, requires_grad=True)
    gy = torch.randn((2, 5, 9, 8), dtype=torch.float64)
    want = [conv(x)]
    want += torch.autograd.grad(want[0], (x, conv.weight, conv.bias), gy)
    got = [split_conv2d(_circular(x, k), conv.weight, conv.bias)]
    got += torch.autograd.grad(got[0], (x, conv.weight, conv.bias), gy)
    for a, b in zip(got, want):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12


def test_andrew_cnn_trains_through_the_route_unchanged():
    """An AndrewCNN's training gradients on the route equal those of the
    same net with every conv an `nn.Conv2d`, in float64."""
    net = _small_net()
    x = torch.randn((2, 8, 8, 3), dtype=torch.float64)
    net.train()
    params = list(net.parameters())
    got = torch.autograd.grad(net(x).square().sum(), params)
    plain = nets.split_conv2d
    try:
        nets.split_conv2d = F.conv2d
        want = torch.autograd.grad(net(x).square().sum(), params)
    finally:
        nets.split_conv2d = plain
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_counter_rises_once_a_conv_a_training_backward():
    net = _small_net()
    x = torch.randn((2, 8, 8, 3), dtype=torch.float64)
    net.train()
    before = _splits()
    for n in (1, 2):
        net(x).sum().backward()
        assert _splits() - before == n * net.n_layers


def test_conv_modules_keep_hooks_and_wrappers():
    """The route runs inside each conv module's call, so forward hooks on
    the convs still fire in training; a wrapper that calls the conv's
    `_conv_forward` (as `parallel.mesh.ColumnParallel` does) bypasses it
    while the net's other convs take it."""
    net = _small_net().train()
    seen = []
    for i in range(net.n_layers):
        getattr(net, f"Conv_{i}").register_forward_hook(
            lambda m, args, y, i=i: seen.append(i))
    plain = net.Conv_1

    class Wrapped(nn.Module):
        def forward(self, x):
            return plain._conv_forward(x, plain.weight, plain.bias)
    x = torch.randn((2, 8, 8, 3), dtype=torch.float64)
    before = _splits()
    net(x).sum().backward()
    assert seen == list(range(net.n_layers))
    assert _splits() - before == net.n_layers
    net.Conv_1 = Wrapped()
    net(x).sum().backward()
    assert _splits() - before == 2 * net.n_layers - 1


@pytest.mark.parametrize("case", ["no_grad", "eval", "frozen", "critic"])
def test_counter_stays_outside_training(case):
    """No split backward under `torch.no_grad`, in eval mode, with frozen
    weights, or in the GAN's critic (its penalty's double backward keeps
    `nn.Conv2d`)."""
    x = torch.randn((2, 8, 8, 3), dtype=torch.float64, requires_grad=True)
    before = _splits()
    if case == "critic":
        torch.manual_seed(0)
        D = DCGANDiscriminator(3, ndf=4, nx=16).double()
        xd = torch.randn((2, 16, 16, 3), dtype=torch.float64,
                         requires_grad=True)
        dx, = torch.autograd.grad(D(xd).sum(), xd, create_graph=True)
        dx.square().sum().backward()
    else:
        net = _small_net()
        net.train(case != "eval")
        if case == "frozen":
            net.requires_grad_(False)
        if case == "no_grad":
            with torch.no_grad():
                net(x)
        else:
            net(x).sum().backward()
    assert _splits() == before


def test_input_gradient_rule_by_shape():
    """Of the sigma-VAE's convs, only the 5x5 to 128 channels (a sum of
    3,200 terms an input gradient element) keeps PyTorch's input
    gradient."""
    own = {(ci, co, k) for _, ci, co, k, _ in _sigma_vae_convs()
           if not cudnn_input_grad(k, co)}
    assert own == {(4, 128, 5)}


def test_double_backward_raises():
    net = _small_net().train()
    x = torch.randn((2, 8, 8, 3), dtype=torch.float64, requires_grad=True)
    dx, = torch.autograd.grad(net(x).square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


# -------------------------------------------------------------------- card
def _sigma_vae_convs():
    """The sigma-VAE's 16 convs: (name, c_in, c_out, k, input gradient)."""
    out = []
    for part, net in (("encoder", AndrewCNN(4, 4)),
                      ("decoder", AndrewCNN(4, 2))):
        for i in range(net.n_layers):
            co, ci, k, _ = getattr(net, f"Conv_{i}").weight.shape
            out.append((f"{part}.Conv_{i}", ci, co, k,
                        not (part == "encoder" and i == 0)))
    return out


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.cuda
def test_route_forward_and_input_gradient_on_card():
    """At every sigma-VAE conv shape at 8 x 64^2, the route's forward and
    input gradient read at most 1e-6 relative RMS from float64 on the CPU,
    and its forward and weight and bias gradients are bitwise those of
    PyTorch's own path (`exact_fp32_training`, plain `F.conv2d`) for the
    same input and incoming gradient."""
    dev = _card()
    rng = np.random.default_rng(17)
    for name, ci, co, k, dx in _sigma_vae_convs():
        x = torch.tensor(rng.standard_normal((8, ci, 64 + k - 1,
                                              64 + k - 1)))
        w = torch.tensor(rng.standard_normal((co, ci, k, k))
                         / np.sqrt(ci * k * k))
        b = torch.tensor(rng.standard_normal(co) * 0.1)
        gy = torch.tensor(rng.standard_normal((8, co, 64, 64)))
        xr = x.clone().requires_grad_()
        ref = F.conv2d(xr, w, b)
        gx_ref, = torch.autograd.grad(ref, xr, gy)

        def run(conv):
            xs = x.float().to(dev).requires_grad_(dx)
            ws = w.float().to(dev).requires_grad_()
            bs = b.float().to(dev).requires_grad_()
            with exact_fp32_training():
                y = conv(xs, ws, bs)
                wrt = (xs, ws, bs) if dx else (ws, bs)
                return (y,) + torch.autograd.grad(y, wrt,
                                                  gy.float().to(dev))
        got, plain = run(split_conv2d), run(F.conv2d)
        assert _rel(got[0], ref) <= 1e-6, (name, "forward")
        assert torch.equal(got[0], plain[0]), (name, "forward")
        if dx:
            assert _rel(got[1], gx_ref) <= 1e-6, (name, "input gradient")
        # the same incoming gradient: weight and bias bitwise
        assert torch.equal(got[-2], plain[-2]), (name, "weight gradient")
        assert torch.equal(got[-1], plain[-1]), (name, "bias gradient")


@pytest.mark.cuda
def test_vae_step_repeats_bitwise_on_card():
    """Two `VaeTrainer` steps from one state and batch leave the same
    parameters, optimizer state and BatchNorm statistics, bit for bit, and
    each backward takes the route at all 16 convs."""
    dev = _card()
    from pyqg_generative_torch.models import CVAERegression
    from pyqg_generative_torch.models.cvae_regression import VaeTrainer
    g = torch.Generator(device=dev).manual_seed(5)
    data = tuple(torch.randn((64, 64, 64, 2), generator=g, device=dev)
                 for _ in range(3))

    def step():
        net = CVAERegression(folder=str(ROOT / "build" / "missing"),
                             device=dev)
        trainer = VaeTrainer(net, data, 2, 32, 2e-4, key=11)
        before = _splits()
        trainer.step(0, trainer.batches()[0])
        torch.cuda.synchronize()
        assert _splits() - before == 16
        out = {}
        for mod, m in net._vae_modules().items():
            for k, v in m.state_dict().items():
                out[f"{mod}.{k}"] = v.clone()
        for k, v in trainer.opt_state["mu"].items():
            out[f"mu.{k}"] = v.clone()
        return out
    a, b = step(), step()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_wgrad_spans_reach_the_benchmark_trace_on_card():
    """The `train.conv_wgrad` spans, opened on the autograd engine's
    thread, land in the benchmark's profiler trace: 16 a VAE step whose
    backward runs on the host, which `train.split_convs_per_batch` reads.
    On the card the trainer's second step is captured in a CUDA graph
    (its backward runs once, as the capture) and the third replayed (no
    backward on the host): 16 in the two."""
    dev = _card()
    sys.path.insert(0, str(ROOT))
    from benchmark import tracing
    from pyqg_generative_torch.models import CVAERegression
    from pyqg_generative_torch.models.cvae_regression import VaeTrainer
    g = torch.Generator(device=dev).manual_seed(6)
    data = tuple(torch.randn((64, 64, 64, 2), generator=g, device=dev)
                 for _ in range(3))
    net = CVAERegression(folder=str(ROOT / "build" / "missing"), device=dev)
    trainer = VaeTrainer(net, data, 2, 16, 2e-4, key=12)
    perm = trainer.batches()
    trainer.step(0, perm[0])
    out = []
    with tracing.traced(out):
        for i in (1, 2):
            trainer.step(i, perm[i])
    names = [h[0] for h in out[-1].host]
    assert names.count("train.conv_wgrad") == 16
    assert names.count("train.replay") == 2
