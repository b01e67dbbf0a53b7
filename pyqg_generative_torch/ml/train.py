"""The training machinery: Adam on the twin's schedule, shuffled epochs on
device-resident data or streamed from the native loader, mid-run
checkpoints, the loss log.

Twin of `pyqg_generative_tpu/ml/train.py`. The twin's epoch is one
`lax.scan`; here it is a Python loop over the rows of `epoch_permutation`
(a numpy copy of the twin's, so that both packages draw the same batches),
each row gathered from tensors that stay on the device. Parameters and
BatchNorm statistics live in the torch module: a train-mode forward updates
the statistics (`ml.nets.BatchNorm`), so the twin's threaded `batch_stats`
is the module's state. The optimizer is optax's Adam written out in torch
(`Adam`), one tensor at a time in optax's order of operations, with a
piecewise-constant schedule read at the optimizer's own update count and
the values that change from step to step held in device tensors, so that
a CUDA graph can replay the update (`ml/train_graph.py`); its
state is a plain dict of tensors and the count, which the checkpoint holds
beside the module state dicts (`utils/checkpoints.py`). `fit_streaming`
feeds the same step from `utils.native.FastLoader` through pinned buffers.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch

from ..utils import xrlite as xr
from ..utils.profiling import span

__all__ = ["Adam", "TrainingState", "piecewise_constant_schedule",
           "multistep_adam", "fit", "make_train_step", "log_to_dataset",
           "apply_in_batches", "epoch_permutation", "init_training_state",
           "named_params", "mean_metrics", "TrainCheckpointer",
           "fit_streaming"]


class TrainCheckpointer:
    """Mid-run training checkpoint and resume (twin :27-105).

    Saves, every `every` epochs, the training carry (any tree of
    `utils.checkpoints`) and a JSON sidecar with the epoch counter, the loss
    log, the numpy Generator's state and the torch Generator's state (where
    the twin keeps its jax key), so that a resumed run continues bit for
    bit. `restore(template, generator)` sets `generator`'s state and returns
    (epoch0, carry, log, rng, generator, extra), or None."""

    def __init__(self, folder: str | None, every: int = 25,
                 name: str = "train_ckpt"):
        self.path = None
        if folder and every > 0:
            os.makedirs(folder, exist_ok=True)
            self.path = os.path.join(folder, name + ".npz")
        self.every = max(1, int(every))

    def maybe_save(self, epoch: int, carry, log: dict,
                   rng: np.random.Generator, generator, extra=None):
        if self.path is not None and epoch % self.every == 0:
            self.save(epoch, carry, log, rng, generator, extra)

    def save(self, epoch: int, carry, log: dict, rng: np.random.Generator,
             generator, extra=None):
        if self.path is None:
            return
        from ..utils.checkpoints import save_checkpoint
        save_checkpoint(self.path, carry)
        meta = {"epoch": int(epoch), "log": log,
                "rng_state": rng.bit_generator.state,
                "generator_state": None if generator is None
                else generator.get_state().tolist(),
                "extra": extra or {}}
        tmp = self.path + ".meta.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self.path + ".meta.json")

    def restore(self, carry_template, generator=None):
        if self.path is None or not os.path.exists(self.path) or \
                not os.path.exists(self.path + ".meta.json"):
            return None
        from ..utils.checkpoints import load_checkpoint
        carry = load_checkpoint(self.path, carry_template)
        with open(self.path + ".meta.json") as f:
            meta = json.load(f)
        rng = np.random.default_rng()
        rng.bit_generator.state = meta["rng_state"]
        if generator is not None and meta["generator_state"] is not None:
            generator.set_state(torch.tensor(meta["generator_state"],
                                             dtype=torch.uint8))
        return (meta["epoch"], carry, meta["log"], rng, generator,
                meta.get("extra", {}))

    def clear(self):
        if self.path is not None:
            for p in (self.path, self.path + ".meta.json"):
                if os.path.exists(p):
                    os.remove(p)
            d = os.path.dirname(self.path)
            if os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Mapping[int, float]):
    """optax's `piecewise_constant_schedule`: count -> init_value times the
    scale of every boundary <= count. The boundaries are a dict's keys, so
    a repeated boundary counts once (torch's MultiStepLR would count it
    again)."""
    items = sorted(dict(boundaries_and_scales).items())

    def schedule(count: int) -> float:
        v = init_value
        for boundary, scale in items:
            if count >= boundary:
                v = v * scale
        return v
    return schedule


class Adam:
    """optax's `adam(learning_rate, b1, b2, eps=1e-8)`, written out: per
    tensor, mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, then
    p + (-lr(count)) * (mu / (1 - b1^(count+1))) / (sqrt(nu / (1 -
    b2^(count+1))) + eps), with the schedule read at the count before the
    update, as optax reads it. The state is {"count": int, "mu": {name:
    tensor}, "nu": {name: tensor}}; `step` updates parameters and state in
    place.

    The values that change from step to step (the rate and both bias
    corrections) reach the arithmetic (`update`) as 0-dim tensors on the
    parameters' device (`scalars`), written before each update, so that a
    CUDA graph that captured `update` replays it with the values of the
    step it replays. Each rounds as the Python float it stands for: a CUDA
    kernel divides a tensor by a Python float by multiplying with the
    float's reciprocal, formed in double and rounded to the tensor's
    precision, so on CUDA a bias correction is kept as that reciprocal and
    multiplied by; on the CPU, which divides by the float rounded to the
    tensor's precision, it is kept as itself and divided by. So an update
    is bitwise the one Python floats give, on either device."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate if callable(learning_rate) \
            else (lambda count: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self._scalars: dict = {}

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def scalars(self, like: torch.Tensor, count: int | None = None) -> tuple:
        """The update's (-rate, mu's bias correction, nu's) for parameters
        like `like`: 0-dim tensors on its device in its dtype (float32 or
        float64), the same ones for the optimizer's life. With `count`,
        first written with that count's values, by three fills on the
        current stream."""
        key = (like.device, like.dtype)
        out = self._scalars.get(key)
        if out is None:
            if like.dtype not in (torch.float32, torch.float64):
                raise ValueError(f"Adam's scalars take float32 or float64 "
                                 f"parameters, not {like.dtype}")
            out = self._scalars[key] = tuple(
                torch.zeros((), device=like.device, dtype=like.dtype)
                for _ in range(3))
        if count is not None:
            c1 = 1 - self.b1 ** (count + 1)
            c2 = 1 - self.b2 ** (count + 1)
            if like.is_cuda:
                c1, c2 = 1 / c1, 1 / c2
            # each fill rounds its Python float to the tensor's precision
            for t, v in zip(out, (-self.learning_rate(count), c1, c2)):
                t.fill_(v)
        return out

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads,
               state: dict, scalars: tuple) -> None:
        """One update's arithmetic, in place, inside the span
        `train.optimizer`, with `scalars` as `scalars` wrote them: it reads
        no host value that changes between steps, and leaves the count to
        the caller."""
        b1, b2 = self.b1, self.b2
        step_size, c1, c2 = scalars
        with span("train.optimizer"):
            for (name, p), g in zip(params.items(), grads):
                mu = state["mu"][name]
                nu = state["nu"][name]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                update = _over(mu, c1) / (torch.sqrt(_over(nu, c2))
                                          + self.eps)
                p.copy_(p + step_size * update)

    def step(self, params: Mapping[str, torch.Tensor], grads, state: dict):
        count = state["count"]
        like = next(iter(params.values()))
        self.update(params, grads, state, self.scalars(like, count))
        state["count"] = count + 1


def _over(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """t over the bias correction that `Adam.scalars` wrote into c."""
    return t * c if t.is_cuda else t / c


def multistep_adam(lr: float, num_epochs: int, steps_per_epoch: int,
                   gamma: float = 0.1, b1: float = 0.9,
                   b2: float = 0.999) -> Adam:
    """Adam with the reference's MultiStepLR schedule: the rate times gamma
    at 1/2, 3/4 and 7/8 of training (twin :115-122)."""
    bounds = {int(num_epochs * f) * steps_per_epoch: gamma
              for f in (0.5, 0.75, 0.875)}
    return Adam(piecewise_constant_schedule(lr, bounds), b1=b1, b2=b2)


def epoch_permutation(rng: np.random.Generator, n: int, batch_size: int):
    """Shuffled indices reshaped to (steps, batch) with wrap-around padding so
    shapes are static and every sample is seen at least once per epoch."""
    steps = int(np.ceil(n / batch_size))
    perm = rng.permutation(n)
    pad = steps * batch_size - n
    if pad:
        perm = np.concatenate([perm, rng.choice(n, pad, replace=False)
                               if pad <= n else rng.integers(0, n, pad)])
    return perm.reshape(steps, batch_size)


def named_params(module: torch.nn.Module) -> dict:
    """The module's trainable parameters by state-dict name."""
    return dict(module.named_parameters())


@dataclass
class TrainingState:
    """A module (parameters and BatchNorm statistics), its optimizer's state
    and the count of training steps taken."""
    module: torch.nn.Module
    opt_state: dict
    step: int = 0


def init_training_state(module: torch.nn.Module, tx: Adam,
                        generator: torch.Generator) -> TrainingState:
    """Fresh weights drawn from `generator` by the twin's initializers
    (`ml.nets.init_weights`, the twin's `model.init`) and a fresh optimizer
    state."""
    from .nets import init_weights
    init_weights(module, generator)
    return TrainingState(module, tx.init(named_params(module)), 0)


def make_train_step(loss_fn: Callable, module: torch.nn.Module, tx: Adam):
    """step(opt_state, batch) -> metrics: the module in train mode, the
    gradient of loss_fn(batch, True) -> (loss, metrics) with respect to its
    parameters, one optimizer update (the body of the twin's `train_epoch`,
    :198-211)."""
    params = named_params(module)

    def step(opt_state, batch):
        module.train()
        loss, metrics = loss_fn(batch, True)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.step(params, grads, opt_state)
        return {k: v.detach() for k, v in metrics.items()}
    return step


def mean_metrics(rows: list) -> dict:
    """Each metric's mean over the batches, one host copy for them all."""
    keys = list(rows[0])
    means = torch.stack([torch.stack([r[k] for r in rows]).mean().to(
        torch.float64) for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, means)}


def fit(loss_fn: Callable, state: TrainingState, tx: Adam,
        train_arrays: tuple, test_arrays: tuple,
        num_epochs: int, batch_size: int,
        rng: np.random.Generator | None = None,
        epoch_hook: Callable | None = None,
        log_dict: dict | None = None,
        verbose: bool = True,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 25):
    """Run the generic training loop (twin :146-244).

    loss_fn(batch, train) -> (loss, metrics_dict) on the state's module
    (its mode set by the loop); train_arrays / test_arrays: tuples of
    tensors of one leading length, on the module's device; each minibatch
    is the tuple gathered at the shuffled indices. The test epoch draws its
    own permutation from `rng` after the train epoch, as the twin does.
    epoch_hook(state, epoch) -> dict of extra metrics. With
    `checkpoint_dir`, the module, the optimizer state and the step count are
    checkpointed every `checkpoint_every` epochs and restored (bit-for-bit
    resume) on restart. Returns (state, log) with per-epoch series."""
    rng = rng or np.random.default_rng(0)
    module = state.module
    device = train_arrays[0].device
    n = int(train_arrays[0].shape[0])
    log = log_dict if log_dict is not None else {}

    def carry():
        return {"module": module.state_dict(), "opt": state.opt_state,
                "step": state.step}

    ckpt = TrainCheckpointer(checkpoint_dir, checkpoint_every)
    epoch0 = 0
    resumed = ckpt.restore(carry())
    if resumed is not None:
        epoch0, saved, saved_log, rng, _, _ = resumed
        module.load_state_dict(saved["module"])
        state.opt_state, state.step = saved["opt"], saved["step"]
        log.clear()
        log.update(saved_log)
        if verbose:
            print(f"resuming training from epoch {epoch0}")

    step = make_train_step(loss_fn, module, tx)
    n_test = int(test_arrays[0].shape[0]) if test_arrays else 0
    t_start = time.time()
    for epoch in range(epoch0, num_epochs):
        t_e = time.time()
        perm = torch.as_tensor(epoch_permutation(rng, n, batch_size),
                               device=device)
        rows = []
        for idx in perm:
            rows.append(step(state.opt_state,
                             tuple(a[idx] for a in train_arrays)))
        state.step += len(rows)
        metrics = mean_metrics(rows)
        if n_test:
            perm_t = torch.as_tensor(epoch_permutation(
                rng, n_test, min(batch_size, n_test)), device=device)
            module.eval()
            with torch.no_grad():
                rows = [loss_fn(tuple(a[idx] for a in test_arrays),
                                False)[1] for idx in perm_t]
            metrics.update({f"{k}_test": v
                            for k, v in mean_metrics(rows).items()})
        if epoch_hook is not None:
            metrics.update(epoch_hook(state, epoch))
        for k, v in metrics.items():
            log.setdefault(k, []).append(v)
        ckpt.maybe_save(epoch + 1, carry(), log, rng, None)
        if verbose:
            t = time.time()
            eta = (t - t_start) * (num_epochs / (epoch + 1) - 1)
            print(f"[{epoch + 1}/{num_epochs}] [{t - t_e:.2f}/{eta:.2f}] "
                  + " ".join(f"{k}: {v:.4g}" for k, v in metrics.items()
                             if "loss" in k))
    module.eval()
    ckpt.clear()
    return state, log


def fit_streaming(loss_fn: Callable, state: TrainingState, tx: Adam,
                  loader, fields: tuple, num_epochs: int, key=None,
                  draws: Callable | None = None,
                  log_dict: dict | None = None, verbose: bool = True):
    """Training loop fed by a host-side `utils.native.FastLoader` (twin
    :247-294), for data that do not fit on the card (device-resident `fit`
    is preferred otherwise): the loader's threads assemble the next shuffled
    batches while the card runs the current update.

    loss_fn(batch, train) -> (loss, metrics) on the state's module, batch =
    the store's `fields` in order, as tensors on the module's device in its
    dtype, plus `draws(generator, batch)` where given: the twin's per-batch
    key split becomes a torch.Generator on the module's device, seeded with
    `key` (an int, 0 by default, or a Generator), from which `draws` draws.
    Epoch e reads `loader.epoch(seed=e)`, as the twin does.

    On a card each batch lands in one of two pinned host buffers and
    goes to the card in one non-blocking copy on a copy stream, so that the
    copy of batch b+1 overlaps the update of batch b. A host buffer is
    refilled only after the event recorded behind its copy has completed,
    and its device buffer only after the update that read it. The metrics
    are summed on the device and read on the host once an epoch, as
    per-epoch means under the twin's keys. Returns (state, log)."""
    n_buffers = 2
    module = state.module
    p0 = next(module.parameters())
    device, dtype = p0.device, p0.dtype
    generator = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(key or 0))
    log = log_dict if log_dict is not None else {}
    step = make_train_step(loss_fn, module, tx)
    meta = loader.meta["fields"]
    shape = (loader.batch_size, loader.sample_floats)
    cuda = device.type == "cuda"
    if cuda:
        host = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                for _ in range(n_buffers)]
        dev = [torch.empty(shape, dtype=torch.float32, device=device)
               for _ in range(n_buffers)]
        copied = [torch.cuda.Event() for _ in range(n_buffers)]
        used = [torch.cuda.Event() for _ in range(n_buffers)]
        copy_stream = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)
    else:
        host = [np.empty(shape, dtype=np.float32) for _ in range(n_buffers)]

    def to_device(k: int) -> torch.Tensor:
        """Batch k's flat rows on the device, ordered on the compute
        stream."""
        if not cuda:
            return torch.from_numpy(host[k]).to(dtype, copy=True)
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(used[k])
            dev[k].copy_(host[k], non_blocking=True)
            copied[k].record(copy_stream)
        compute.wait_event(copied[k])
        return dev[k]

    def batch_of(flat: torch.Tensor) -> tuple:
        out = []
        for f in fields:
            info = meta[f]
            seg = flat[:, info["offset"]:info["offset"] + info["size"]]
            out.append(seg.reshape((flat.shape[0],) + tuple(info["shape"]))
                       .to(dtype))
        return tuple(out)

    def before_fill(k: int):
        if cuda:
            copied[k].synchronize()

    t_start = time.time()
    for epoch in range(num_epochs):
        t_e = time.time()
        sums, count = {}, 0
        for b, _ in enumerate(loader.epoch(seed=epoch, out=host,
                                           before_fill=before_fill)):
            k = b % n_buffers
            batch = batch_of(to_device(k))
            if draws is not None:
                batch = batch + tuple(draws(generator, batch))
            metrics = step(state.opt_state, batch)
            if cuda:
                used[k].record(compute)
            for name, v in metrics.items():
                sums[name] = sums[name] + v if name in sums else v
            count += 1
        state.step += count
        if sums:
            means = torch.stack([v.to(torch.float64) for v in sums.values()]
                                ).cpu() / max(count, 1)
            for name, v in zip(sums, means):
                log.setdefault(name, []).append(float(v))
        if verbose:
            t = time.time()
            eta = (t - t_start) * (num_epochs / (epoch + 1) - 1)
            print(f"[{epoch + 1}/{num_epochs}] [{t - t_e:.2f}/{eta:.2f}] "
                  + " ".join(f"{k}: {v[-1]:.4g}" for k, v in log.items()
                             if "loss" in k))
    module.eval()
    return state, log


def log_to_dataset(log: Mapping[str, list]) -> xr.Dataset:
    """Per-epoch loss series -> Dataset with an `epoch` coordinate
    (reference tools/cnn_tools.py:12-19)."""
    ds = xr.Dataset()
    for k, v in log.items():
        v = np.asarray(v)
        ds[k] = xr.DataArray(v, dims=("epoch",),
                             coords={"epoch": np.arange(1, len(v) + 1)})
    return ds


def apply_in_batches(fn: Callable, *arrays, batch_size: int = 64,
                     device=None):
    """`fn` over consecutive batches of `arrays` (numpy or tensors, batch
    axis first), each batch handed over as tensors on `device` (the arrays'
    own where None), its outputs copied to the host and concatenated there
    (replaces the reference's `apply_function`, tools/cnn_tools.py:702-735).
    `fn` maps a tuple of batches to a tensor or a tuple of tensors; returns
    a numpy array or a list of them."""
    n = arrays[0].shape[0]
    outs = []
    for i in range(0, n, batch_size):
        batch = tuple(torch.as_tensor(a[i:i + batch_size], device=device)
                      for a in arrays)
        y = fn(*batch)
        y = (y,) if not isinstance(y, (tuple, list)) else y
        outs.append([v.cpu().numpy() for v in y])
    outs = list(zip(*outs))
    outs = [np.concatenate(o, axis=0) for o in outs]
    return outs[0] if len(outs) == 1 else outs
