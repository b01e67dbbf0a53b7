"""Multi-replica training: K GAN or VAE replicas stepped in lockstep.

Twin of `pyqg_generative_tpu/ml/multifit.py`. The reference trains its 5
realizations of a (model, operator, resolution) as 5 jobs on 5 GPUs
(scripts/train_parameterizations.py:26-35); the twin vmaps them into one
XLA program. Here the K replicas take each batch in turn over one copy of
the data on the device (`cgan_regression.run_epochs`), each through the
single trainer's own code (`GanTrainer`, `VaeTrainer`): its batch step
(`make_gan_batch_step`, `make_vae_step`), its numpy default_rng(key), which
shuffles, and its torch.Generator seeded with key, which draws its weights
and every batch's draws in `train_CGAN`'s order. So replica r is bitwise
`fit(..., key=keys[r])`, where the twin's vmapped lowering drifts about
5e-5 an epoch from its sequential run (its :13-18).

`torch.func.vmap` over the replicas does not fit: the train-mode
`ml.nets.BatchNorm` updates its running statistics in place, and the
critic's gradient penalty calls `torch.autograd.grad(..., create_graph=True)`
inside the step. Stacking the replicas as grouped convolutions is speed
work for later (ROADMAP, queue 2).

Replicas may share one dataset (multi-seed: it is prepared and put on the
device once) or bring their own of the same shape (multi-dataset, e.g.
Operator1 and Operator2 at one resolution), each with its own scalers. The
set checkpoints as one file, `{gan,vae}_multi_ckpt.npz` in the first
replica's folder, with the epoch inside it and in a JSON sidecar written
last, which also holds each replica's log, best epoch and generator states;
a torn pair (the two epochs disagree) raises.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from ..models.base import prepare_PV_data
from ..models.cgan_regression import GanTrainer, run_epochs
from ..models.common import set_scalers
from ..models.cvae_regression import VaeTrainer
from ..utils.checkpoints import load_checkpoint, save_checkpoint

__all__ = ["fit_gan_ensemble", "fit_vae_ensemble"]


def _prepare(nets, ds_trains, ds_tests) -> list:
    """Each replica's scalers and its (X, Y, zeros) on its device; a
    dataset pair shared by identity is prepared and moved once (twin
    :50-70). Raises unless every replica's data have one shape."""
    cache, data = {}, []
    for net, dtr, dte in zip(nets, ds_trains, ds_tests):
        k = (id(dtr), id(dte))
        if k not in cache:
            X, Y, _, _, x_scale, y_scale = prepare_PV_data(dtr, dte)
            cache[k] = (tuple(torch.as_tensor(a, device=net.device)
                              for a in (X, Y, np.zeros_like(Y))),
                        x_scale, y_scale)
        arrays, x_scale, y_scale = cache[k]
        set_scalers(net, x_scale, y_scale)
        data.append(arrays)
    shapes = {tuple(d[0].shape) for d in data}
    if len(shapes) != 1:
        raise ValueError(f"replica datasets must have identical shapes for "
                         f"lockstep training, got {sorted(shapes)}")
    return data


def _check_homogeneous(nets, attr_names):
    """One configuration for the whole set, without a mean net (twin
    :138-146)."""
    for a in attr_names + ("device",):
        vals = {repr(getattr(n, a, None)) for n in nets}
        if len(vals) != 1:
            raise ValueError(f"an ensemble requires identical `{a}` across "
                             f"replicas, got {vals}")
    if getattr(nets[0], "regression", "None") != "None":
        raise ValueError("an ensemble supports regression='None' only "
                         "(the replicas' mean nets are not trained)")


class _MultiCheckpointer:
    """One checkpoint for the replica set (twin :73-135): every replica's
    carry and the epoch in `<name>.npz`, and a sidecar `<name>.npz.meta.json`
    with the epoch, each replica's log and best epoch and its numpy and
    torch generators' states, written after the carry. A resumed run is
    bitwise an unbroken one; it needs the same replica set."""

    def __init__(self, folder: str | None, every: int, name: str):
        self.path = None
        if folder and every > 0:
            os.makedirs(folder, exist_ok=True)
            self.path = os.path.join(folder, name + ".npz")
        self.every = max(1, int(every))

    def _tree(self, trainers, epoch: int) -> dict:
        return {"epoch": np.int64(epoch),
                "replicas": [t.checkpoint() for t in trainers]}

    def maybe_save(self, epoch: int, trainers) -> None:
        if self.path is None or epoch % self.every:
            return
        # the epoch is inside the carry's file and in the sidecar, the
        # sidecar written last: a crash between the two leaves epochs that
        # disagree, which restore() refuses
        save_checkpoint(self.path, self._tree(trainers, epoch))
        meta = {"epoch": int(epoch), "logs": [t.log for t in trainers],
                "extras": [t.extra() for t in trainers],
                "rng_states": [t.rng.bit_generator.state for t in trainers],
                "generator_states": [t.generator.get_state().tolist()
                                     for t in trainers]}
        tmp = self.path + ".meta.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self.path + ".meta.json")

    def restore(self, trainers) -> int:
        if self.path is None or not os.path.exists(self.path) or \
                not os.path.exists(self.path + ".meta.json"):
            return 0
        saved = load_checkpoint(self.path, self._tree(trainers, 0))
        with open(self.path + ".meta.json") as f:
            meta = json.load(f)
        if int(saved["epoch"]) != int(meta["epoch"]):
            raise RuntimeError(
                f"multifit checkpoint {self.path} is torn: carry epoch "
                f"{int(saved['epoch'])} != meta epoch {meta['epoch']} (a "
                f"crash between the carry's and the sidecar's writes); "
                f"delete both to restart")
        for t, carry, log, extra, rs, gs in zip(
                trainers, saved["replicas"], meta["logs"], meta["extras"],
                meta["rng_states"], meta["generator_states"]):
            t.log = log
            t.rng.bit_generator.state = rs
            t.generator.set_state(torch.tensor(gs, dtype=torch.uint8))
            t.restore(carry, extra)
        return int(meta["epoch"])

    def clear(self) -> None:
        if self.path is not None:
            for p in (self.path, self.path + ".meta.json"):
                if os.path.exists(p):
                    os.remove(p)


def _fit_ensemble(make_trainer, ckpt_name, what, nets, ds_trains, ds_tests,
                  num_epochs, nruns, keys, verbose, checkpoint_every,
                  retain_every=0):
    keys = list(keys) if keys is not None else list(range(len(nets)))
    data = _prepare(nets, ds_trains, ds_tests)
    trainers = [make_trainer(net, d, key)
                for net, d, key in zip(nets, data, keys)]
    run_epochs(trainers, ds_trains, ds_tests, num_epochs, nruns,
               _MultiCheckpointer(nets[0].folder, checkpoint_every,
                                  ckpt_name),
               verbose, retain_every, what)
    for net, t in zip(nets, trainers):
        net.save_model(t.log)
    return [t.log for t in trainers]


def fit_gan_ensemble(nets: Sequence, ds_trains, ds_tests,
                     num_epochs: int = 200, batch_size: int = 64,
                     learning_rate: float = 2e-4, nruns: int = 5,
                     keys: Sequence[int] | None = None, verbose: bool = True,
                     retain_every: int = 0, checkpoint_every: int = 25):
    """Train K CGANRegression replicas in lockstep (twin :262-354); replica
    r ends as `nets[r].fit(ds_trains[r], ds_tests[r], key=keys[r])` would,
    bitwise, with its own G and D, `G_opt.msgpack`, `epoch_bank/` and
    `stats.npz`. Returns the replicas' logs."""
    _check_homogeneous(nets, ("regression", "generator", "nx", "div",
                              "hidden_channels"))
    return _fit_ensemble(
        lambda net, d, key: GanTrainer(net, d, num_epochs, batch_size,
                                       learning_rate, key),
        "gan_multi_ckpt", "GAN ensemble", nets, ds_trains, ds_tests,
        num_epochs, nruns, keys, verbose, checkpoint_every, retain_every)


def fit_vae_ensemble(nets: Sequence, ds_trains, ds_tests,
                     num_epochs: int = 200, batch_size: int = 64,
                     learning_rate: float = 2e-4, nruns: int = 5,
                     keys: Sequence[int] | None = None, verbose: bool = True,
                     checkpoint_every: int = 25):
    """Train K CVAERegression replicas in lockstep (twin :357-434), each
    bitwise its own `fit`, with `decoder_opt.msgpack` and `stats.npz`."""
    _check_homogeneous(nets, ("regression", "div", "decoder_var",
                              "hidden_channels"))
    return _fit_ensemble(
        lambda net, d, key: VaeTrainer(net, d, num_epochs, batch_size,
                                       learning_rate, key),
        "vae_multi_ckpt", "VAE ensemble", nets, ds_trains, ds_tests,
        num_epochs, nruns, keys, verbose, checkpoint_every)
