"""What each rank of `entry.dryrun_multichip` runs: the multi-device paths
held against one device's, on one rank a device (`parallel.spawn`).

* `gan_step`: a full GAN batch step (`models.cgan_regression.
  make_gan_batch_step`, critic with its gradient penalty, then the
  generator) of the untrained 16^2 GAN (`entry.untrained_gan`, its critic
  drawn by `ml.nets.init_weights` from seed 1) on a dp x tp mesh: the batch
  of 4 dp over "dp" with the generator's BatchNorm statistics synchronised
  and the gradients averaged (`DataParallel`), the conv output channels of
  generator and critic over "tp" (`tensor_parallel`); against one rank's
  step on the whole batch with the same draws (`gan_draws` for the whole
  batch), in float64 and in float32 (see the bars below). The twin checks
  only that its step's result is finite.
* `ensemble_gan`: `run_ensemble` of the GAN in float32 (K1 on a card), AR1,
  diagnostics on, members over an "ens" axis of every rank, against the
  unsharded run: bitwise on one rank, else to ENS_BAR.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ml import fused_conv
from ..ml.nets import init_weights
from ..ml.train import Adam, named_params
from ..models.cgan_regression import LAMBDA_DRIFT, gan_draws, \
    make_gan_batch_step
from ..qg.params import QGParams
from ..sim.simulate import run_ensemble
from .mesh import DataParallel, batch_sharding, ensemble_sharding, \
    gather_state_dict, make_mesh, sync_batchnorm, tensor_parallel

__all__ = ["rank_checks", "dp_tp_split"]

LR = 2e-4
# The sharded step sums in another order than one rank's (a rank's
# convolutions see a smaller batch, BatchNorm sums over ranks, a tp slice's
# input gradient is all-reduced, a split conv adds its bias after the
# gather). In float64 the gradients (each tensor to its largest entry), the
# BatchNorm statistics, the losses and the parameters after Adam's first
# update (lr g / (|g| + 1e-8)) are held to float64's sums; the generator's
# loss, which the step logs in float32 as the twin does, to float32's
# rounding.
GRAD_BAR, STATS_BAR, LOSS_BAR, PARAM_BAR = 1e-10, 1e-12, 1e-12, 1e-12
G_LOSS_BAR = 1e-6
# In float32 a unit whose pre-activation lies within rounding of 0 (a ReLU
# of the generator, a LeakyReLU of the critic) can land on the other side
# of its kink in the sharded step, and that moves a gradient by percents:
# on 2 gloo ranks a critic unit at 1.8e-7 of its call's largest
# pre-activation moved the critic's and the generator's gradients by 2.1%,
# on 4 a generator unit at 2.2e-8 moved the generator's by 1.9%. The step
# is not continuous there, so the float32 check takes the inputs of the
# first seed, of F32_SEEDS from 0, on which no such unit changes sign on
# any rank (`kink_units`), and holds the gradients, losses and BatchNorm
# statistics to float32's sums: on 1 to 4 gloo ranks and seeds 0-5, the 17
# runs without such a unit read at most 5.3e-6, 1.3e-6 and 3.3e-7, and
# each of the 7 with one read gradient errors of 1.2-15%
# (scripts/torch_gan_step_kinks.py). The critic's loss is a difference of
# means of its outputs that nearly cancel, so it and the generator's are
# held to the critic's RMS output. Adam's first update is about lr sign(g),
# so a gradient entry within rounding of 0 may move its parameter by up to
# 2 lr: the parameters are held to that (a misplaced tp slice moves one by
# the weights' scale, 0.02).
F32_SEEDS = 8
GRAD32_BAR, STATS32_BAR, LOSS32_BAR = 5e-5, 1e-5, 1e-5
PARAM32_BAR = 2 * LR
# a member of the sharded float32 GAN ensemble against the unsharded run,
# to max|q|, where ranks hold fewer members than one device does
ENS_BAR = 1e-5


def dp_tp_split(n: int) -> tuple[int, int]:
    """The twin's (dp, tp) of n devices (`__graft_entry__.py:137-143`)."""
    if n >= 4 and n % 2 == 0:
        return n // 2, 2
    if n == 2:
        return 1, 2
    return n, 1


def _max_rel(out: dict, ref: dict, rows) -> float:
    """max over tensors of max|out - ref| / max|ref|, each ref tensor cut to
    the rows a tp slice holds (`rows(n)` -> slice) where it is larger."""
    worst = 0.0
    for name, v in out.items():
        r = ref[name]
        if v.shape != r.shape:
            r = r[rows(r.shape[0])]
        worst = max(worst, float((v - r).abs().max())
                    / (float(r.abs().max()) or 1.0))
    return worst


def _tp_rows(mesh, axis="tp"):
    group = mesh.get_group(axis)
    t, tp = dist.get_rank(group), dist.get_world_size(group)
    return lambda n: slice(t * n // tp, (t + 1) * n // tp)


def _preactivations(model) -> list:
    """Keep, in call order, every output of the layers that a ReLU or
    LeakyReLU reads next, as (net, output): the generator's hidden convs
    and the critic's four stride-2 convs."""
    seen = []
    G, D = model.G, model.D
    for net, layer in [("G", getattr(G, f"Conv_{i}"))
                       for i in range(G.n_layers - 1)] \
            + [("D", getattr(D, f"Conv_{i}")) for i in range(4)]:
        layer.register_forward_hook(
            lambda m, args, y, net=net: seen.append((net, y.detach())))
    return seen


def _kinks(pre: list, pre_ref: list, rows: slice, device) -> dict:
    """The units of every rank whose pre-activation has another sign in
    `pre` than in `pre_ref` (cut to `rows`), by net, and the smallest
    |pre-activation| among them in the reference, to its call's largest
    (None where there is none)."""
    units = torch.zeros(2, dtype=torch.int64, device=device)
    margin = torch.full((), torch.inf, dtype=torch.float64, device=device)
    for (net, a), (_, r) in zip(pre, pre_ref, strict=True):
        r = r[rows]
        flip = (a > 0) != (r > 0)
        units[int(net == "D")] += flip.sum()
        if flip.any():
            margin = torch.minimum(margin, (r[flip].abs().min()
                                            / r.abs().max()).double())
    dist.all_reduce(units)
    dist.all_reduce(margin, op=dist.ReduceOp.MIN)
    return {"kink_units": int(units.sum()),
            "kink_units_by_net": dict(zip("GD", units.tolist())),
            "kink_margin": float(margin) if units.any() else None}


def gan_step(mesh, device, dtype=torch.float64, seed: int = 0) -> dict:
    """One GAN batch step sharded against one rank's on the inputs of
    `seed`, at the bars of `dtype`; `kink_units` counts the units of every
    rank whose pre-activation changed sign between the two (`_kinks`)."""
    from ..entry import untrained_gan
    dp = dist.get_world_size(mesh.get_group("dp"))
    nx, batch = 16, 4 * dp
    f64 = dtype == torch.float64

    def gan():
        model = untrained_gan(nx, device=device, inference_dtype="float32")
        init_weights(model.D, torch.Generator(device=device).manual_seed(1))
        model.G.to(dtype)
        model.D.to(dtype)
        return model

    def adam():
        return Adam(LR, b1=0.5, b2=0.999)

    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    x = torch.randn((batch, nx, nx, 2), generator=gen, **kw)
    y = torch.randn((batch, nx, nx, 2), generator=gen, **kw)
    ym = torch.zeros((batch, nx, nx, 2), **kw)
    z1, z2, eps, swap = gan_draws(gen, x, 2)

    ref = gan()
    pre_ref = _preactivations(ref)
    txG, txD = adam(), adam()
    opt = {"G": txG.init(named_params(ref.G)),
           "D": txD.init(named_params(ref.D))}
    grads = {}
    m_ref = make_gan_batch_step(ref, txG, txD)(
        opt, (x, y, ym), 0, (z1, z2, eps, swap), grads)

    model = gan()
    for net in (model.G, model.D):
        tensor_parallel(net, mesh, "tp")
    sync_batchnorm(model.G, mesh, "dp")
    pre = _preactivations(model)
    txG, txD = (DataParallel(adam(), mesh, "dp") for _ in range(2))
    opt = {"G": txG.init(named_params(model.G)),
           "D": txD.init(named_params(model.D))}
    lo, hi = batch_sharding(mesh, "dp").rows(batch)
    m = make_gan_batch_step(model, txG, txD)(
        opt, (x[lo:hi], y[lo:hi], ym[lo:hi]), 0,
        (z1[lo:hi], z2[lo:hi], eps[lo:hi], swap))

    names = sorted(m)
    losses = torch.stack([m[k].to(torch.float64) for k in names])
    dist.all_reduce(losses, group=mesh.get_group("dp"))
    losses = losses / dp
    loss_ref = torch.stack([m_ref[k].to(torch.float64) for k in names])
    scale = loss_ref.abs().clamp_min(1e-30)
    if not f64:
        # D_loss and G_loss are means of critic outputs, D_loss a
        # difference of such means: to the critic's RMS output on the true
        # pairs, which D_drift holds
        rms = (m_ref["D_drift"].to(torch.float64) / LAMBDA_DRIFT).sqrt()
        for k in ("D_loss", "G_loss"):
            scale[names.index(k)] = torch.maximum(scale[names.index(k)],
                                                  rms)
    rel = (losses - loss_ref).abs() / scale
    rows = _tp_rows(mesh)
    out = {"dtype": str(dtype).removeprefix("torch."), "seed": seed,
           **_kinks(pre, pre_ref, slice(lo, hi), device),
           "loss_err": max(float(e) for k, e in zip(names, rel)
                           if k != "G_loss"),
           "g_loss_err": float(rel[names.index("G_loss")]),
           "grad_err": max(_max_rel(tx.last_grads, grads[k], rows)
                           for k, tx in (("G", txG), ("D", txD)))}
    param_err, stats_err = 0.0, 0.0
    for name in ("G", "D"):
        full = gather_state_dict(getattr(model, name))
        for k, v in getattr(ref, name).state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            err = float((full[k] - v).abs().max())
            if "running" in k:
                stats_err = max(stats_err,
                                err / (float(v.abs().max()) or 1.0))
            else:
                param_err = max(param_err, err)
    out.update(param_err=param_err, stats_err=stats_err)
    bars = (LOSS_BAR, G_LOSS_BAR, GRAD_BAR, STATS_BAR, PARAM_BAR) if f64 \
        else (LOSS32_BAR, LOSS32_BAR, GRAD32_BAR, STATS32_BAR, PARAM32_BAR)
    out["ok"] = all(out[k] <= bar for k, bar in zip(
        ("loss_err", "g_loss_err", "grad_err", "stats_err", "param_err"),
        bars))
    return out


def gan_step_f32(mesh, device) -> dict:
    """`gan_step` in float32 on the first seed with no unit at a kink (see
    F32_SEEDS); the seeds passed over and their `kink_units`."""
    skipped = {}
    for seed in range(F32_SEEDS):
        out = gan_step(mesh, device, torch.float32, seed)
        if not out["kink_units"]:
            return {**out, "skipped": skipped}
        skipped[seed] = out["kink_units"]
    return {"ok": False, "skipped": skipped}


def ensemble_gan(ens_mesh, n: int, device) -> dict:
    from ..entry import untrained_gan
    p = QGParams(nx=16, dt=14400.0, tmax=2 * 14400.0, tavestart=0.0,
                 precision="single")
    closure = {"self": untrained_gan(16, device=device,
                                     inference_dtype="float32"),
               "sampling": "AR1", "nsteps": 1}
    kw = dict(n_ens=n, sampling_freq=2 * 14400.0, with_diags=True,
              device=device)
    before = fused_conv.launches
    ds = run_ensemble(p, closure, sharding=ensemble_sharding(ens_mesh),
                      **kw)
    out = {"k1_launches": fused_conv.launches - before}
    ref = run_ensemble(p, closure, **kw)
    q, q_ref = ds["q"].values, ref["q"].values
    out["bitwise"] = sorted(ds.keys()) == sorted(ref.keys()) and all(
        np.array_equal(ds[k].values, ref[k].values) for k in ref.keys())
    out["err"] = float(np.abs(q - q_ref).max() / np.abs(q_ref).max())
    out["finite"] = bool(np.isfinite(q).all())
    out["ok"] = out["finite"] and (out["bitwise"] if n == 1
                                   else out["err"] <= ENS_BAR)
    return out


def rank_checks(n_devices: int, device_type: str) -> dict:
    """Every check of the module's docstring on this rank; raises naming
    those that fail, else returns their readings."""
    device = resolve_device(None if device_type == "cuda" else "cpu")
    dp, tp = dp_tp_split(n_devices)
    mesh = make_mesh({"dp": dp, "tp": tp})
    ens_mesh = make_mesh({"ens": n_devices})
    out = {"dp": dp, "tp": tp, "ens": n_devices,
           "gan_step": gan_step(mesh, device),
           "gan_step_f32": gan_step_f32(mesh, device),
           "ensemble_gan": ensemble_gan(ens_mesh, n_devices, device)}
    failed = {k: v for k, v in out.items()
              if isinstance(v, dict) and not v["ok"]}
    if failed:
        raise AssertionError(f"dryrun_multichip, rank "
                             f"{dist.get_rank()}: {failed}")
    return out
