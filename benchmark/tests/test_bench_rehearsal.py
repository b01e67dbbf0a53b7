"""Each cell at 16^2 on the CPU through `run.run`: correct against the
plain reference; the reference in bf16 put in the program's place fails
the cell's limits; and a run with the timed path broken underneath comes
out not correct, once for each fault that the cell can have (one chip, so
no exchange between chips to leave out)."""
import dataclasses

import pytest
import torch

from conftest import ROOT

from benchmark import drivers, manifest

MAN = manifest.load()


@pytest.mark.parametrize("cell", ["gan64_online", "vae64_train"])
def test_cell_is_correct(run_cell, cell):
    out = run_cell(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def _driver(cell, seed):
    w = manifest.cell(MAN, cell)
    tr = manifest.traffic(w["traffic"])
    d = drivers.load(tr["driver"])(manifest.config(MAN, w["config"]), tr,
                                   seed, "cpu", ROOT)
    d.setup()
    d.window(0.0)
    d.release()
    return d


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_bf16_control_fails_online(tiny, seed):
    from benchmark.drivers.online_ensemble import compare
    d = _driver("gan64_online", seed)
    jobs = [d.jobs[i] for i in d.sample()]
    numbers = compare(d.reference(jobs, "bfloat16"), d.reference(jobs))
    limits = manifest.limits("gan64_online")["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_bf16_control_fails_training(tiny, seed):
    from benchmark.drivers.training import compare
    d = _driver("vae64_train", seed)
    ref = d.reference()
    numbers = compare(*d.reference("bfloat16")[:2], d.start,
                      d.reference("bfloat16")[2], *ref)
    limits = manifest.limits("vae64_train")["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


# ---------------------------------------------------------------- faults
def _online_fault(monkeypatch, kind):
    from pyqg_generative_torch.sim import simulate
    real_step, real_snap = simulate.make_online_step, simulate._snapshot

    def make(p, *args, **kw):
        step = real_step(p, *args, **kw)

        def unchanged(carry):
            return carry

        def half(carry):
            state = carry[0]
            new = step(carry)
            n = state.qh.shape[0] // 2
            keep = {k: torch.cat([getattr(new[0], k)[:n],
                                  getattr(state, k)[n:]])
                    for k in ("qh", "dqhdt_p", "dqhdt_pp")}
            return (dataclasses.replace(new[0], **keep),) + tuple(new[1:])
        return {"unchanged": unchanged, "half_batch": half}.get(kind, step)

    def altered(state, p):
        snap = real_snap(state, p)
        return {**snap, "q": snap["q"] * 1.01}

    monkeypatch.setattr(simulate, "make_online_step", make)
    if kind == "altered":
        monkeypatch.setattr(simulate, "_snapshot", altered)


def _training_fault(monkeypatch, kind):
    from pyqg_generative_torch.ml import train
    from pyqg_generative_torch.models import cvae_regression as cv
    real = cv.VaeTrainer.step
    if kind == "unchanged":
        monkeypatch.setattr(train.Adam, "step", lambda *a, **k: None)
    elif kind == "half_batch":
        monkeypatch.setattr(cv.VaeTrainer, "step", lambda self, i, idx: real(
            self, i, idx[:len(idx) // 2]))
    else:
        def altered(self, i, idx):
            m = real(self, i, idx)
            return {**m, "loss": m["loss"] * 1.01}
        monkeypatch.setattr(cv.VaeTrainer, "step", altered)


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["gan64_online", "vae64_train"])
def test_a_broken_timed_path_is_not_correct(run_cell, monkeypatch, cell,
                                            kind):
    fault = _online_fault if cell == "gan64_online" else _training_fault
    fault(monkeypatch, kind)
    assert not run_cell(cell)["correct"]


def test_a_fault_of_a_few_leaves_fails_change_worst(run_cell, monkeypatch):
    """The BatchNorm scales alone moved double in the last compared step
    (so that no other leaf's gradient feels it): too few leaves for the
    median leaf's `change_gap` to see, which `change_worst` catches."""
    from pyqg_generative_torch.models import cvae_regression as cv
    real = cv.VaeTrainer.step
    last = manifest.traffic("train_b64_21414")["check_steps"] - 1

    def doubled(self, i, idx):
        if i != last:
            return real(self, i, idx)
        scales = [p for m in self.net._vae_modules().values()
                  for n, p in m.named_parameters()
                  if n.startswith("BatchNorm") and n.endswith("weight")]
        before = [p.detach().clone() for p in scales]
        out = real(self, i, idx)
        with torch.no_grad():
            for p, b in zip(scales, before):
                p.add_(p - b)
        return out
    monkeypatch.setattr(cv.VaeTrainer, "step", doubled)
    out = run_cell("vae64_train")
    checks = out["checks"]
    assert checks["change_gap"]["value"] <= checks["change_gap"]["limit"]
    assert checks["change_worst"]["value"] > checks["change_worst"]["limit"]
    assert not out["correct"]
