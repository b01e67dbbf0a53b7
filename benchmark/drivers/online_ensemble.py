"""Online ensembles of a closure in the loop: jobs of
`pyqg_generative_torch.sim.run_ensemble`, back to back, as
`exp/pipeline.py::run_parameterized` calls it.

Traffic keys: `members`; `steps_per_snapshot` and `snapshots` (a job's
length); `sampling` ("AR1") and `nsteps`; `diagnostics` and
`tavestart_days`; `check_jobs` (how many jobs, drawn from the seed, the
reference follows); `warmup_snapshots` and `warmup_steps_per_snapshot`
(the set-up's job). Member j of job k starts from the JAMES initial
condition keyed key_k * 1000 + j, as `run_ensemble` draws it.

End-to-end: `online_member_steps_per_s`, every member-step of the jobs
run in the window over the wall time from the first job's start to the
end of the last, which ends in the copy of its snapshots to the host.
Correctness: for the sampled jobs the reference (`reference/qg.py`) runs
the same members from the same keys, and `snapshot_gap` (the worst member
and snapshot of q, u, v and psi, the L2 norm of the difference over the
reference's) and `diagnostic_gap` (the worst member and diagnostic, the
largest difference over the reference's largest value) are compared.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import inputs, tracing
from ..reference import precision, qg
from ..reference.cnn import read_weights
from . import Window

DAY = 86400.0
FIELDS = ("q", "u", "v", "psi")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root: Path):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.device, self.root = torch.device(device), Path(root)
        self.members = int(traffic["members"])
        self.jobs: list = []   # (key, {output: numpy array}) a job
        self.marks: list = []  # (set-up phase, perf_counter at its end)

    # ------------------------------------------------------------ set-up
    def _params(self, steps_per_snap: int, n_snaps: int):
        from pyqg_generative_torch.qg.params import QGParams
        phys = self.cfg["physics"]
        return QGParams(**phys, precision="single",
                        tavestart=self.tr["tavestart_days"] * DAY,
                        tmax=steps_per_snap * n_snaps * phys["dt"])

    def setup(self) -> None:
        from pyqg_generative_torch.models import load_model
        from pyqg_generative_torch.sim import run_ensemble
        self._run_ensemble = run_ensemble
        self.marks.append(("imports", time.perf_counter()))
        self.model = load_model(
            str(self.root / self.cfg["folder"]), device=self.device,
            inference_dtype=self.cfg["inference_dtype"],
            online_variant=self.cfg["online_variant"])
        self._sync()
        self.marks.append(("model", time.perf_counter()))
        tr = self.tr
        self.p = self._params(tr["steps_per_snapshot"], tr["snapshots"])
        warm = self._params(tr["warmup_steps_per_snapshot"],
                            tr["warmup_snapshots"])
        self._job(warm, inputs.stream_key(self.seed, "jobs", 4095),
                  tr["warmup_steps_per_snapshot"])
        self._sync()
        self.marks.append(("warm-up job", time.perf_counter()))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _job(self, p, key: int, steps_per_snap: int):
        closure = {"self": self.model, "sampling": self.tr["sampling"],
                   "nsteps": self.tr["nsteps"]}
        with tracing.span("benchmark.run_ensemble"):
            return self._run_ensemble(
                p, closure, n_ens=self.members,
                sampling_freq=steps_per_snap * p.dt, key=key,
                with_diags=self.tr["diagnostics"], device=self.device)

    # ------------------------------------------------------------ window
    def _counts(self) -> dict:
        from pyqg_generative_torch.ml import fused_conv
        from pyqg_generative_torch.sim import graph
        return {"eager_steps": graph.eager_steps,
                "captured_steps": graph.captured_steps,
                "replayed_steps": graph.replayed_steps,
                "k1_calls": fused_conv.launches,
                "k1_bf16_calls": fused_conv.launches_bf16,
                "k2_calls": fused_conv.launches_packed}

    def window(self, seconds: float, trace: list | None = None) -> Window:
        tr = self.tr
        steps = tr["steps_per_snapshot"] * tr["snapshots"]
        before = self._counts()
        traced_work: dict = {}
        units = []
        t0 = t = time.perf_counter()
        while True:
            k = len(self.jobs)
            key = inputs.stream_key(self.seed, "jobs", k)
            if trace is not None and not traced_work:
                with tracing.traced(trace):
                    ds = self._job(self.p, key, tr["steps_per_snapshot"])
                if trace[-1].kernels():
                    traced_work = {"job": k, "steps": steps,
                                   "member_steps": steps * self.members}
                else:  # the profiler missed the stretch: trace the next
                    trace.pop()
            else:
                ds = self._job(self.p, key, tr["steps_per_snapshot"])
            self.jobs.append((key, {v: np.asarray(ds[v].values)
                                    for v in ds.keys() if v != "time"}))
            units.append(time.perf_counter() - t)
            t += units[-1]
            if t - t0 >= seconds and (
                    trace is None or traced_work or len(self.jobs) >= 3):
                break
        wall = t - t0
        after = self._counts()
        if traced_work:  # the untraced jobs' rate, which tracing leaves be
            rest = [u for i, u in enumerate(units) if i != traced_work["job"]]
            traced_work["untraced_rate"] = \
                len(rest) * steps * self.members / sum(rest) if rest else None
        failed = sum(not all(np.isfinite(out[f]).all() for f in FIELDS)
                     for _, out in self.jobs)
        return Window(
            end_to_end={"online_member_steps_per_s":
                        len(self.jobs) * steps * self.members / wall},
            attempted=len(self.jobs), failed=failed,
            counters={k: after[k] - before[k] for k in after},
            units=units, traced_work=traced_work)

    def release(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------- correctness
    def sample(self) -> list:
        """The jobs that the reference follows, drawn from the seed."""
        rng = np.random.default_rng(inputs.stream_key(self.seed, "sample"))
        n = min(int(self.tr["check_jobs"]), len(self.jobs))
        return sorted(rng.choice(len(self.jobs), n, replace=False).tolist())

    def reference(self, jobs: list, mode: str = "float32") -> list:
        """The reference's outputs of `jobs` [(key, ...)], one dict of
        snapshots and diagnostic means (numpy, the program's layout) a
        job; the jobs run as one batch."""
        cfg, tr = self.cfg, self.tr
        ref = cfg["reference"]
        folder = self.root / cfg["folder"]
        scales = {s: np.asarray(json.loads(
            (folder / f"{s}_scale.json").read_text())["std"])
            for s in ("x", "y")}
        phys = qg.Physics(**cfg["physics"],
                          tavestart=tr["tavestart_days"] * DAY)
        model = qg.QGModel(phys, self.device)
        closure = qg.Closure(read_weights(str(folder / ref["weights"])),
                             scales["x"], scales["y"], self.device, mode)
        n, m = phys.nx, self.members
        with precision(mode), torch.no_grad():
            q0 = np.stack([qg.james_initial_condition(n, phys.L,
                                                      key * 1000 + i)
                           for key, _ in jobs for i in range(m)])
            gens = [torch.Generator(device=self.device).manual_seed(key)
                    for key, _ in jobs]
            snaps, diags = model.run(
                torch.from_numpy(q0), closure, gens, ref["n_latent"], m,
                tr["nsteps"], tr["steps_per_snapshot"], tr["snapshots"],
                tr["diagnostics"])
        out = []
        for g in range(len(jobs)):
            rows = slice(g * m, (g + 1) * m)
            out.append({**{f: snaps[f][rows].cpu().numpy() for f in FIELDS},
                        **{d: v[rows].cpu().numpy()
                           for d, v in diags.items()}})
        return out

    def check(self) -> dict:
        jobs = [self.jobs[i] for i in self.sample()]
        return compare([out for _, out in jobs], self.reference(jobs))


def compare(program: list, reference: list) -> dict:
    """`snapshot_gap` and `diagnostic_gap` of program outputs against the
    reference's, job by job (see the module's docstring); a non-finite
    output reads infinity."""
    snap, diag = 0.0, 0.0
    for prog, ref in zip(program, reference):
        for f in FIELDS:
            a, b = prog[f].astype(np.float64), ref[f].astype(np.float64)
            num = np.sqrt(((a - b) ** 2).sum(axis=(-3, -2, -1)))
            den = np.sqrt((b ** 2).sum(axis=(-3, -2, -1)))
            snap = max(snap, _worst(num / den))
        for k, b in ref.items():
            if k in FIELDS:
                continue
            a, b = prog[k].astype(np.float64), b.astype(np.float64)
            axes = tuple(range(1, b.ndim))
            num = np.abs(a - b).max(axis=axes)
            den = np.abs(b).max(axis=axes)
            diag = max(diag, _worst(num / den))
    return {"snapshot_gap": snap, "diagnostic_gap": diag}


def _worst(x: np.ndarray) -> float:
    return float(np.max(x)) if np.isfinite(x).all() else float("inf")
