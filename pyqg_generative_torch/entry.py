"""The port's entry point: one online step of the flagship configuration.

Twin of `entry()` in `__graft_entry__.py` (:22-73): one solver step of the
64^2 two-layer QG model (dt = 14400 s, float32) with a GAN closure evaluated
inside the step, AR1 white noise, no diagnostics. The GAN is untrained: an
AndrewCNN generator in bf16 online, its weights drawn from a seeded numpy
generator (`ml.weights.seeded_variables`, no flax `init`), and the twin's
physical-scale normalisers. On a card its Conv_1..Conv_7 run in K1-bf16,
after K3 has resolved the packing at the model's first step. The twin's
`dryrun_multichip` waits for the port's `parallel/`.

Run one step: python -m pyqg_generative_torch.entry
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ml.nets import AndrewCNN
from .ml.scalers import ChannelwiseScaler
from .ml.weights import params_from_jax, seeded_variables
from .models.cgan_regression import CGANRegression
from .qg import core
from .qg.params import QGParams
from .sim.simulate import make_online_step
from .sim.stochastic import init_sampler

__all__ = ["entry", "untrained_gan"]


def untrained_gan(nx: int = 64, seed: int = 0, device=None) -> CGANRegression:
    """CGANRegression(nx, inference_dtype="bfloat16") on seeded weights,
    with the twin's normalisers (x std 1e-5, y std 1e-11; :41-42), built
    from no folder."""
    model = CGANRegression(nx=nx, folder="/nonexistent_model_folder",
                           inference_dtype="bfloat16", device=device)
    model.vars_G = seeded_variables(
        AndrewCNN(2 + model.n_latent, 2,
                  hidden_channels=model.hidden_channels), seed)
    model.G.load_state_dict(params_from_jax(model.vars_G))
    model.x_scale = ChannelwiseScaler.from_stats([0.0, 0.0], [1e-5, 1e-5])
    model.y_scale = ChannelwiseScaler.from_stats([0.0, 0.0],
                                                 [1e-11, 1e-11])
    model._x_std = torch.as_tensor(model.x_scale.std, device=model.device)
    model._y_std = torch.as_tensor(model.y_scale.std, device=model.device)
    model.weights_generation += 1
    return model


def entry(device=None):
    """(fn, (state, sstate)): fn(state, sstate) -> (state, sstate), one step
    of the GAN-closed 64^2 model, and its first arguments on `device` (None
    means CUDA): the twin's initial condition of seed 0 and a sampler whose
    generator is seeded with 0."""
    device = resolve_device(device)
    p = QGParams(nx=64, dt=14400.0, precision="single")
    model = untrained_gan(64, device=device)
    step = make_online_step(p, model, sampling="AR1", nsteps=1,
                            with_diags=False)

    def fn(state, sstate):
        state, sstate, _ = step((state, sstate, None))
        return state, sstate

    q0 = core.default_initial_q(p, rng=np.random.default_rng(0))
    state = core.init_state(q0, p, device=device)
    sstate = init_sampler(0, model, p.ny_, p.nx, core.dtypes(p)[0],
                          device=device)
    return fn, (state, sstate)


if __name__ == "__main__":
    fn, args = entry()
    state, _ = fn(*args)
    torch.cuda.synchronize()
    print(f"entry() ran one step on {torch.cuda.get_device_name(0)}; "
          f"q finite: {bool(torch.isfinite(state.qh).all())}")
