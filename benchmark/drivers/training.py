"""Training of the sigma-VAE closure: `cvae_regression.VaeTrainer`,
stepped batch after batch through its epoch's permutation, as
`models/cgan_regression.py::run_epochs` drives it (a new permutation at
each epoch's end; `end_epoch`'s offline evaluation and checkpoint are left
out).

The configuration gives `learning_rate`, `num_epochs` (the schedule's
length) and `adam_b1`. Traffic keys: `samples` (the device-resident
training set: X, Y and the zero mean-net Y, standard normal from the
seed), `batch_size`, `check_steps` (the first steps, run in set-up
through the window's own call and followed by the reference) and
`trace_batches`.

End-to-end: `train_samples_per_s`, every sample of every batch run in the
window over the wall time from the first batch's enqueue to the
synchronisation after the last. Correctness: the reference
(`reference/vae.py`) takes the same first steps from the same weights,
rows and draws, and `loss_gap` (the worst step's loss or mean squared
error), `grad_gap` (the first gradient as Adam's state holds it after one
step, mu / (1 - b1)), `change_gap` and `change_worst` (the parameters'
change after the first steps) and `stats_gap` (the BatchNorm statistics'
change) are compared, all but the first leaf by leaf: the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. `grad_gap`, `change_worst` and
`stats_gap` take the worst leaf, `change_gap` the median leaf. Adam scales
each element's update to about the learning rate, so in a small leaf (a
bias of 2 to 128 elements) one element whose gradient is a
near-cancellation moves the leaf's norm by its rounding: the worst leaf's
change gap wanders from seed to seed among such leaves, the median leaf's
holds. The median sees a fault of most leaves at a tight limit, the worst
leaf a fault of a few (the BatchNorm scales alone, say) at a looser one.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from .. import inputs, tracing
from ..reference import precision
from ..reference.vae import SigmaVAE, batch_rows
from . import Window

# the step's loss and the terms of it that the reference follows: the
# sigma-VAE's reconstruction term is half the pixel count by construction,
# so its mean squared error carries what the loss hides. The KL term is
# followed too but not compared: from fresh weights it is a float32
# cancellation, 0.5 (exp(lv) - 1 - lv) at lv near 0, whose rounding reads
# 5e-4 to 2e-3 in sound runs, more than TF32 moves it
TERMS = ("loss", "MSE", "loss_KL")
COMPARED = ("loss", "MSE")


def _ref_name(name: str) -> str:
    """A program parameter's name as the reference's: Conv weights are
    `kernel`, BatchNorm weights `scale`, running statistics `mean` and
    `var`."""
    mod, layer, attr = name.rsplit(".", 2)
    attr = {"weight": "kernel" if layer.startswith("Conv") else "scale",
            "running_mean": "mean", "running_var": "var"}.get(attr, attr)
    return f"{mod}.{layer}.{attr}"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root: Path):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.device, self.root = torch.device(device), Path(root)
        self.marks: list = []  # (set-up phase, perf_counter at its end)
        self.batch = int(traffic["batch_size"])
        self.key = inputs.stream_key(self.seed, "train")

    # ------------------------------------------------------------ set-up
    def _model(self):
        from pyqg_generative_torch.ml.weights import params_from_jax
        from pyqg_generative_torch.models import MODEL_REGISTRY
        args = dict(self.cfg["model_args"])
        cls = MODEL_REGISTRY[args.pop("model")]
        # a folder that holds no weights: the nets start from the
        # benchmark's own draws
        net = cls(folder=str(self.root / "build" / "benchmark" / "fresh"),
                  device=self.device, **args)
        hidden = args["hidden_channels"]
        gen = inputs.generator(self.seed, "weights", self.device)
        self.trees = {"enc": inputs.andrew_variables(gen, 4, 4, hidden),
                      "dec": inputs.andrew_variables(gen, 4, 2, hidden)}
        net.encoder.load_state_dict(params_from_jax(self.trees["enc"]))
        net.decoder.load_state_dict(params_from_jax(self.trees["dec"]))
        net.vars_enc, net.vars_dec = self.trees["enc"], self.trees["dec"]
        return net

    def _state(self) -> dict:
        """Copies of the trained parameters and BatchNorm statistics, by
        the reference's names."""
        out = {}
        for mod, module in self.net._vae_modules().items():
            for name, t in list(module.named_parameters()) + list(
                    module.named_buffers()):
                if not name.endswith("num_batches_tracked"):
                    out[_ref_name(f"{mod}.{name}")] = t.detach().clone()
        return out

    def setup(self) -> None:
        from pyqg_generative_torch.models.cvae_regression import VaeTrainer
        self.marks.append(("imports", time.perf_counter()))
        nx, n = self.cfg["nx"], int(self.tr["samples"])
        self.net = self._model()
        self._sync()
        self.marks.append(("model", time.perf_counter()))
        gen = inputs.generator(self.seed, "data", self.device)
        X = inputs.samples(gen, n, nx)
        Y = inputs.samples(gen, n, nx)
        self.data = (X, Y, torch.zeros_like(Y))
        self._sync()
        self.marks.append(("data", time.perf_counter()))
        self.trainer = VaeTrainer(self.net, self.data, self.cfg["num_epochs"],
                                  self.batch, self.cfg["learning_rate"],
                                  self.key)
        self.perm, self.i = self.trainer.batches(), 0
        # the first steps, through the window's own call, followed by the
        # reference
        self.start = self._state()
        self.losses, self.check_terms = [], []
        for _ in range(int(self.tr["check_steps"])):
            metrics = self._step()
            self.check_terms.append({k: float(metrics[k]) for k in TERMS})
            if self.i == 1:
                b1 = self.cfg["adam_b1"]
                self.first_grad = {
                    _ref_name(k): v.detach().clone() / (1 - b1)
                    for k, v in self.trainer.opt_state["mu"].items()}
        self.after = self._state()
        self.losses = []
        self._sync()
        self.marks.append(("first steps", time.perf_counter()))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self) -> dict:
        if self.i == len(self.perm):  # a new epoch
            self.perm, self.i = self.trainer.batches(), 0
        with tracing.span("benchmark.trainer_step"):
            metrics = self.trainer.step(self.i, self.perm[self.i])
        self.losses.append(metrics["loss"])
        self.i += 1
        return metrics

    # ------------------------------------------------------------ window
    def window(self, seconds: float, trace: list | None = None) -> Window:
        n_trace = int(self.tr["trace_batches"])
        traced_work: dict = {}
        traced_s = 0.0  # the traced stretches' wall time, tracing included
        t0 = time.perf_counter()
        while True:
            if trace is not None and not traced_work and \
                    len(self.losses) >= 2:
                self._sync()
                t = time.perf_counter()
                with tracing.traced(trace):
                    for _ in range(n_trace):
                        self._step()
                traced_s += time.perf_counter() - t
                if trace[-1].kernels():
                    traced_work = {"batches": n_trace,
                                   "samples": n_trace * self.batch}
                else:  # the profiler missed the stretch: trace the next
                    trace.pop()
            else:
                self._step()
            if time.perf_counter() - t0 >= seconds and (
                    trace is None or traced_work or len(self.losses) > 20):
                break
        self._sync()
        wall = time.perf_counter() - t0
        if traced_work:  # the untraced batches' rate, which tracing leaves be
            traced_work["untraced_rate"] = \
                (len(self.losses) - n_trace) * self.batch / (wall - traced_s)
        losses = torch.stack(self.losses)
        return Window(
            end_to_end={"train_samples_per_s":
                        len(self.losses) * self.batch / wall},
            attempted=len(self.losses),
            failed=int((~torch.isfinite(losses)).sum()),
            traced_work=traced_work)

    def release(self) -> None:
        self.trainer = self.net = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------- correctness
    def reference(self, mode: str = "float32", half: bool = False) -> tuple:
        """(loss terms, first gradients, the state after the first steps) of
        the reference from the same weights, rows and draws; with `half`,
        each batch's second half left out (a fault, for calibration)."""
        X, Y, _ = self.data
        n, nx = len(X), self.cfg["nx"]
        steps = int(self.tr["check_steps"])
        ref = SigmaVAE(self.trees["enc"], self.trees["dec"], self.device,
                       self.cfg["learning_rate"], self.cfg["num_epochs"],
                       math.ceil(n / self.batch))
        rows = torch.as_tensor(batch_rows(self.key, n, self.batch, steps),
                               device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.key)
        losses, first = [], None
        with precision(mode, cudnn=False):
            keep = self.batch // 2 if half else self.batch
            for s in range(steps):
                x = X[rows[s][:keep]].permute(0, 3, 1, 2)
                y = Y[rows[s][:keep]].permute(0, 3, 1, 2)
                eps = torch.randn((self.batch, nx, nx, 2), generator=gen,
                                  device=self.device)[:keep].permute(
                                      0, 3, 1, 2)
                terms, grads = ref.step(x, y, eps, mode)
                losses.append(terms)
                first = grads if first is None else first
        state = {k: v.detach() for k, v in
                 {**ref.params(), **ref.statistics()}.items()}
        return losses, first, state

    def check(self) -> dict:
        losses, grads, state = self.reference()
        return compare(self.check_terms, self.first_grad, self.start,
                       self.after, losses, grads, state)


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's |norm(program) - norm(reference)| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    if not ref:
        return {}
    median = float(np.median(list(ref.values())))
    return {k: abs(prog[k] - r) / max(r, median) if math.isfinite(prog[k])
            else math.inf for k, r in ref.items()}


def compare(losses, first_grad, start, after, ref_losses, ref_grads,
            ref_state, detail: bool = False) -> dict:
    """The five numbers of the module's docstring; with `detail`, also the
    worst leaf of each, by name."""
    terms = {k: max(abs(a[k] - b[k]) / abs(b[k]) if math.isfinite(a[k])
                    else math.inf for a, b in zip(losses, ref_losses))
             for k in TERMS}
    loss_gap = max(terms[k] for k in COMPARED)
    g_prog, g_ref = _norms(first_grad), _norms(ref_grads)
    median = float(np.median(list(g_ref.values())))
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * median]
    stats = [k for k in ref_state if k not in g_ref]
    d_prog = _norms({k: after[k] - start[k] for k in ref_state})
    d_ref = _norms({k: ref_state[k] - start[k] for k in ref_state})
    gaps = {"grad_gap": leaf_gaps(g_prog, g_ref),
            "change_gap": leaf_gaps({k: d_prog[k] for k in moving},
                                    {k: d_ref[k] for k in moving}),
            "stats_gap": leaf_gaps({k: d_prog[k] for k in stats},
                                   {k: d_ref[k] for k in stats})}
    out = {"loss_gap": loss_gap,
           "grad_gap": max(gaps["grad_gap"].values(), default=0.0),
           "change_gap": float(np.median(list(gaps["change_gap"].values()))),
           "change_worst": max(gaps["change_gap"].values(), default=0.0),
           "stats_gap": max(gaps["stats_gap"].values(), default=0.0)}
    if detail:
        out.update({f"{k}_leaf": max(v, key=v.get) for k, v in gaps.items()
                    if v})
        out["left_out"] = sorted(set(g_ref) - set(moving))
        out.update({f"term_{k}_gap": v for k, v in terms.items()})
    return out
