"""The port's entry point: one online step of the flagship configuration.

Twin of `entry()` in `__graft_entry__.py` (:22-73): one solver step of the
64^2 two-layer QG model (dt = 14400 s, float32) with a GAN closure evaluated
inside the step, AR1 white noise, no diagnostics. The GAN is untrained: an
AndrewCNN generator in bf16 online, its weights drawn from a seeded numpy
generator (`ml.weights.seeded_variables`, no flax `init`), and the twin's
physical-scale normalisers. On a card its Conv_1..Conv_7 run in K1-bf16,
after K3 has resolved the packing at the model's first step.

`dryrun_multichip(n)` is the twin's (`__graft_entry__.py:76-188`) over
torch.distributed: n ranks in child processes under a hard timeout
(`parallel.spawn`), one a card over NCCL, or gloo ranks on the CPU with
`device="cpu"` (the twin's virtual mesh). Each rank runs
`parallel.dryrun.rank_checks`: on a dp x tp mesh (the twin's split) a full
GAN batch step of the untrained 16^2 GAN, the batch of 4 dp over "dp"
(BatchNorm statistics synchronised) and the conv output channels over "tp",
held against one rank's step on the whole batch with the same draws, in
float64 and in float32; then `run_ensemble` of the GAN with diagnostics
over an "ens" axis of every rank, held against the unsharded run (bitwise
on one rank). The twin checks only that its results are finite.

Run one step: python -m pyqg_generative_torch.entry
The dry run:  python -m pyqg_generative_torch.entry --dryrun N [--device cpu]
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

__all__ = ["entry", "untrained_gan", "dryrun_multichip"]


def untrained_gan(nx: int = 64, seed: int = 0, device=None,
                  inference_dtype: str = "bfloat16") -> CGANRegression:
    """CGANRegression(nx, inference_dtype) on seeded weights, with the
    twin's normalisers (x std 1e-5, y std 1e-11; :41-42), built from no
    folder."""
    model = CGANRegression(nx=nx, folder="/nonexistent_model_folder",
                           inference_dtype=inference_dtype, device=device)
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


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 900.0) -> list:
    """Validate the multi-device paths on n ranks (see the module's
    docstring). `device=None` means one card a rank over NCCL, and raises
    where the host has fewer cards; "cpu" runs gloo ranks on the CPU. Raises
    when a rank fails or the ranks outlast `timeout` seconds; prints the
    twin's line and returns each rank's readings."""
    from .parallel.dryrun import dp_tp_split
    from .parallel.spawn import run_ranks
    if device is None:
        resolve_device(None)
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} cards, the host has "
                               f"{torch.cuda.device_count()}")
        device_type = "cuda"
    else:
        device_type = torch.device(device).type
    results = run_ranks("pyqg_generative_torch.parallel.dryrun:rank_checks",
                        n_devices, device_type, timeout,
                        {"n_devices": n_devices, "device_type": device_type})
    dp, tp = dp_tp_split(n_devices)
    print(f"dryrun_multichip OK on {n_devices} devices "
          f"(dp={dp}, tp={tp}, ens={n_devices})", flush=True)
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="One step of entry() on the "
                                 "card, or the multi-device dry run")
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="run dryrun_multichip(N) instead")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU (dry run only)")
    args = ap.parse_args()
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=args.device)
    else:
        fn, args = entry()
        state, _ = fn(*args)
        torch.cuda.synchronize()
        print(f"entry() ran one step on {torch.cuda.get_device_name(0)}; "
              f"q finite: {bool(torch.isfinite(state.qh).all())}")
