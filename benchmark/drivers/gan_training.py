"""Training of the conditional WGAN-GP closure: `cgan_regression.GanTrainer`,
stepped batch after batch through its epoch's permutation, as
`models/cgan_regression.py::run_epochs` drives it (a new permutation at
each epoch's end; `end_epoch`'s offline evaluation and checkpoint are left
out): the critic every batch, the generator too on every 5th by index in
the epoch.

The configuration gives `model_args`, `nx`, `learning_rate`, `num_epochs`
(the schedule's length) and `adam_b1`. Traffic keys: `samples` (the
device-resident training set: X, Y and the zero mean-net Y, standard
normal from the seed), `batch_size`, `check_steps` (the first steps, run in
set-up through the window's own call and followed by the reference; on
CUDA they must have captured both branches' graphs and replayed, since the
cell measures the graphed step) and `trace_batches`.

End-to-end: `train_samples_per_s`, every sample of every batch run in the
window over the wall time from the first batch's enqueue to the
synchronisation after the last. Correctness: the reference
(`reference/gan.py`) takes each of the first steps from the program's
state before it (parameters, BatchNorm statistics and both Adams'
moments), with the same rows and draws; each of its Adams keeps its own
count, from 0, advanced by its own updates. Seven numbers are compared,
the first five as `drivers/training.py` names them: `loss_gap` (the worst
step's critic loss, gradient penalty, drift or, on a generator batch,
generator loss, relative to the reference's), `grad_gap` (the first
gradient of each net as Adam's state holds it after the first step, a
generator batch: mu / (1 - b1)), `change_gap` and `change_worst` (the
parameters' change in a step, the median and the worst leaf, the worst
step), `stats_gap` (the generator's BatchNorm statistics' change in a
step, the worst leaf and step), `moment_gap` (both Adams' moments' change
in a step, mu and nu, the worst leaf and step) and `count_gap` (the
largest difference between an Adam's count after a step and the
reference's). Changes are compared leaf by leaf as `training.leaf_gaps`
takes them, each net's leaves against its own median leaf. Leaves whose
reference gradient in the step is under a thousandth of their net's
median leaf's move by round-off alone and are left out; on a critic-only
step the generator's parameters and moments must not move, and each reads
its change over its norm.

Each step is compared from the program's own state because the chain of
steps is chaotic: from fresh weights the critic's loss grows about 1.5
times a step, and after the first generator update a rounding difference
grows with it, so that over 11 chained steps sound runs read as far from
the reference as its TF32 control does (on an H100, over 40 seeds: a
loss gap of up to 8.4e-3 where the control reads from 7.1e-4, the worst
leaf's change up to 0.059 where the control reads from 0.073). One step
from a shared state reads one step's rounding.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from .. import inputs, tracing
from ..reference import precision
from ..reference.gan import WGANGP, draws, epoch_rows
from . import Window
from .training import _norms, _ref_name, leaf_gaps

TERMS = ("D_loss", "D_grad", "D_drift", "G_loss")
COUNTED = ("eager_steps", "captured_steps", "replayed_steps",
           "generator_steps")
NETS = ("G", "D")


def critic_variables(gen: torch.Generator, nx: int, ndf: int = 64,
                     n_in: int = 6, std: float = 0.02) -> dict:
    """A flax tree of fresh critic weights, as its published initialisation
    draws them: every kernel N(0, std^2), no biases; drawn in one call on
    the generator's device."""
    chans = [n_in, ndf, 2 * ndf, 4 * ndf, 8 * ndf, 1]
    k_last = int(nx / 64 * 4)
    shapes = [(4, 4, chans[i], chans[i + 1]) for i in range(4)] + [
        (k_last, k_last, chans[4], 1)]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = (torch.randn(sum(sizes), generator=gen, device=gen.device)
            * std).cpu().numpy()
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    return {"params": {f"Conv_{i}": {"kernel": p.reshape(s)}
                       for i, (p, s) in enumerate(zip(parts, shapes))}}


def _counters() -> dict:
    from pyqg_generative_torch.utils import profiling
    c = profiling.counters()
    return {k: c[f"train.{k}"] for k in COUNTED if f"train.{k}" in c}


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
        args["nx"] = self.cfg["nx"]  # the run's grid
        # a folder that holds no weights: the nets start from the
        # benchmark's own draws
        net = cls(folder=str(self.root / "build" / "benchmark" / "fresh"),
                  device=self.device, **args)
        gen = inputs.generator(self.seed, "weights", self.device)
        self.trees = {
            "G": inputs.andrew_variables(gen, 4, 2, args["hidden_channels"]),
            "D": critic_variables(gen, self.cfg["nx"])}
        net._set_generator(self.trees["G"])
        net.D.load_state_dict(params_from_jax(self.trees["D"]))
        net.vars_D = self.trees["D"]
        return net

    def _state(self) -> tuple:
        """Copies of the trained parameters and BatchNorm statistics, and of
        both Adams' counts and moments ({net: {"count", "mu", "nu"}}), by
        the reference's names."""
        values, opt = {}, {}
        for net in NETS:
            module = getattr(self.net, net)
            for name, t in list(module.named_parameters()) + list(
                    module.named_buffers()):
                if not name.endswith("num_batches_tracked"):
                    values[_ref_name(f"{net}.{name}")] = t.detach().clone()
            state = self.trainer.opt[net]
            opt[net] = {"count": state["count"], **{
                part: {_ref_name(f"{net}.{k}"): v.clone()
                       for k, v in state[part].items()}
                for part in ("mu", "nu")}}
        return values, opt

    def setup(self) -> None:
        from pyqg_generative_torch.models.cgan_regression import GanTrainer
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
        self.trainer = GanTrainer(self.net, self.data, self.cfg["num_epochs"],
                                  self.batch, self.cfg["learning_rate"],
                                  self.key)
        self.perm, self.i = self.trainer.batches(), 0
        # the first steps, through the window's own call, followed by the
        # reference
        self.states = [self._state()]  # before each step, and after all
        self.losses, self.check_terms = [], []
        before = _counters()
        b1 = self.cfg["adam_b1"]
        for _ in range(int(self.tr["check_steps"])):
            gen_step = self.i % 5 == 0
            metrics = self._step()
            self.check_terms.append(
                {k: float(metrics[k]) for k in TERMS} | {"G": gen_step})
            self.states.append(self._state())
            if len(self.check_terms) == 1:
                self.first_grad = {
                    k: v / (1 - b1) for net in NETS
                    for k, v in self.states[-1][1][net]["mu"].items()}
        after = _counters()
        self.losses = []
        self._sync()
        self.marks.append(("first steps", time.perf_counter()))
        if self.device.type == "cuda":
            made = {k: after.get(k, 0) - before.get(k, 0)
                    for k in ("captured_steps", "replayed_steps")}
            if made["captured_steps"] != 2 or made["replayed_steps"] <= 0:
                raise RuntimeError(
                    f"the first {self.tr['check_steps']} steps counted "
                    f"{made}: the cell measures the step graphed a branch, "
                    "two captures and replays after them")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self) -> dict:
        if self.i == len(self.perm):  # a new epoch
            self.perm, self.i = self.trainer.batches(), 0
        with tracing.span("benchmark.trainer_step"):
            metrics = self.trainer.step(self.i, self.perm[self.i])
        self.losses.append(metrics["D_loss"])
        self.losses.append(metrics["G_loss"])
        self.i += 1
        return metrics

    # ------------------------------------------------------------ window
    def window(self, seconds: float, trace: list | None = None) -> Window:
        n_trace = int(self.tr["trace_batches"])
        traced_work: dict = {}
        traced_s = 0.0  # the traced stretch's wall time, tracing included
        before = _counters()
        t0 = time.perf_counter()
        while True:
            batches = len(self.losses) // 2
            if trace is not None and not traced_work and batches >= 2:
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
                    trace is None or traced_work or batches > 20):
                break
        self._sync()
        wall = time.perf_counter() - t0
        after = _counters()
        batches = len(self.losses) // 2
        if traced_work:  # the untraced batches' rate, which tracing leaves be
            traced_work["untraced_rate"] = \
                (batches - n_trace) * self.batch / (wall - traced_s)
            traced_work["window_batches"] = batches
        losses = torch.stack(self.losses)
        return Window(
            end_to_end={"train_samples_per_s": batches * self.batch / wall},
            attempted=batches,
            failed=int((~torch.isfinite(losses.view(-1, 2))).any(1).sum()),
            counters={k: after[k] - before.get(k, 0) for k in after},
            traced_work=traced_work)

    def release(self) -> None:
        self.trainer = self.net = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------- correctness
    def reference(self, mode: str = "float32", half: bool = False,
                  double_backward: bool = True,
                  update_generator: bool = True) -> tuple:
        """Each of the first steps of the reference from the program's state
        before it, with the same rows and draws, its Adams' counts its own:
        (the steps' loss terms, their gradients, after each step the
        parameters and statistics and the Adams' state, as `_state`).
        Faults, for calibration: `half`, each batch's second half left out;
        `double_backward=False`, the penalty's gradient left out of the
        critic's update; `update_generator=False`, the generator's update
        left out (its gradients read 0)."""
        X, Y, _ = self.data
        n, nx = len(X), self.cfg["nx"]
        steps = int(self.tr["check_steps"])
        per_epoch = math.ceil(n / self.batch)
        ref = WGANGP(self.trees["G"], self.trees["D"], self.device,
                     self.cfg["learning_rate"], self.cfg["num_epochs"],
                     per_epoch)
        rows = torch.as_tensor(epoch_rows(self.key, n, self.batch, steps),
                               device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.key)
        keep = self.batch // 2 if half else self.batch
        terms, grads, afters = [], [], []
        with precision(mode, cudnn=False):
            for s in range(steps):
                gen_step = s % per_epoch % 5 == 0
                ref.load(*self.states[s])
                x = X[rows[s][:keep]].permute(0, 3, 1, 2)
                y = Y[rows[s][:keep]].permute(0, 3, 1, 2)
                d = draws(gen, self.batch, nx)
                d = tuple(t[:keep] for t in d[:3]) + d[3:]
                t, g = ref.step(x, y, d, gen_step, mode, double_backward,
                                update_generator)
                if gen_step and g["G"] is None:
                    g["G"] = {k: torch.zeros_like(p)
                              for k, p in ref.g_params().items()}
                terms.append(t | {"G": gen_step})
                grads.append(g["D"] | (g["G"] or {}))
                afters.append(({k: v.detach().clone() for k, v in
                                {**ref.params(), **ref.statistics()}.items()},
                               ref.optimizer_state()))
        return terms, grads, afters

    def check(self) -> dict:
        terms, grads, afters = self.reference()
        return compare(self.check_terms, self.first_grad, self.states[:-1],
                       self.states[1:], terms, grads, afters)


def _net(name: str) -> str:
    return name.split(".", 1)[0]


def compare(terms, first_grad, befores, afters, ref_terms, ref_grads,
            ref_afters, detail: bool = False) -> dict:
    """The seven numbers of the module's docstring. `befores` and
    `afters`: the program's state before and after each step, (parameters
    and statistics, the Adams' state) as `Driver._state` gives them;
    `ref_afters`: the reference's after each step, taken from `befores`;
    `ref_grads`: the reference's gradients in each step. With `detail`,
    also the worst leaf of each (step:name) and each term's gap."""
    gaps_of = {k: [abs(a[k] - b[k]) / abs(b[k]) if math.isfinite(a[k])
                   else math.inf for a, b in zip(terms, ref_terms)
                   if k != "G_loss" or b["G"]] for k in TERMS}
    term_gaps = {k: max(v, default=0.0) for k, v in gaps_of.items()}
    g_prog, g_ref = _norms(first_grad), _norms(ref_grads[0])
    gaps = {"grad_gap": {}, "change_gap": {}, "change_worst": {},
            "stats_gap": {}, "moment_gap": {}, "count_gap": {}}
    for net in NETS:
        ref = {k: v for k, v in g_ref.items() if _net(k) == net}
        gaps["grad_gap"] |= leaf_gaps({k: g_prog[k] for k in ref}, ref)
    for s, (grads, (after, ref_opt)) in enumerate(zip(ref_grads,
                                                     ref_afters)):
        (before, opt), (prog, prog_opt) = befores[s], afters[s]
        d_prog = _norms({k: prog[k] - before[k] for k in after})
        d_ref = _norms({k: after[k] - before[k] for k in after})
        stats, step, moments = _stats(after), {}, {}
        for net in NETS:
            gaps["count_gap"][f"{s}:{net}"] = float(abs(
                prog_opt[net]["count"] - ref_opt[net]["count"]))
            g = _norms({k: v for k, v in grads.items() if _net(k) == net})
            moved = {part: (
                _norms({k: v - opt[net][part][k]
                        for k, v in prog_opt[net][part].items()}),
                _norms({k: v - opt[net][part][k]
                        for k, v in ref_opt[net][part].items()}))
                for part in ("mu", "nu")}
            if not g:  # a net the step does not update stays as it was
                size = _norms({k: v for k, v in before.items()
                               if _net(k) == net and k not in stats})
                step |= {k: d_prog[k] / max(v, 1e-30)
                         for k, v in size.items()}
                for part, (d, _) in moved.items():
                    size = _norms(opt[net][part])
                    moments |= {f"{part}:{k}": v / max(size[k], 1e-30)
                                for k, v in d.items()}
                continue
            median = float(np.median(list(g.values())))
            moving = [k for k in g if g[k] >= 1e-3 * median]
            step |= leaf_gaps({k: d_prog[k] for k in moving},
                              {k: d_ref[k] for k in moving})
            for part, (d, r) in moved.items():
                moments |= {f"{part}:{k}": v for k, v in leaf_gaps(
                    {k: d[k] for k in moving},
                    {k: r[k] for k in moving}).items()}
        gaps["change_gap"][s] = float(np.median(list(step.values())))
        gaps["change_worst"] |= {f"{s}:{k}": v for k, v in step.items()}
        gaps["moment_gap"] |= {f"{s}:{k}": v for k, v in moments.items()}
        gaps["stats_gap"] |= {f"{s}:{k}": v for k, v in leaf_gaps(
            {k: d_prog[k] for k in stats}, {k: d_ref[k] for k in stats}
        ).items()}
    out = {"loss_gap": max(term_gaps.values())} | {
        k: max(v.values(), default=0.0) for k, v in gaps.items()}
    if detail:
        out.update({f"{k}_leaf": max(v, key=v.get) for k, v in gaps.items()
                    if v})
        out.update({f"term_{k}_gap": v for k, v in term_gaps.items()})
    return out


def _stats(values: dict) -> list:
    """The names of the BatchNorm statistics among `values`."""
    return [k for k in values if k.endswith((".mean", ".var"))]
