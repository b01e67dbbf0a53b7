"""On the card, at each cell's own size: the control (the reference with
TF32 on, put in the program's place) fails the cell's limits on three
seeds, while the program passes them. Run there with
`python -m pytest benchmark/tests/test_bench_controls.py -m cuda`."""
import pytest
import torch

from conftest import ROOT

from benchmark import drivers, manifest

MAN = manifest.load()
SEEDS = (71, 2 ** 31 + 72, 73)


def _driver(cell, seed, seconds):
    w = manifest.cell(MAN, cell)
    tr = manifest.traffic(w["traffic"])
    d = drivers.load(tr["driver"])(manifest.config(MAN, w["config"]), tr,
                                   seed, torch.device("cuda"), ROOT)
    d.setup()
    d.window(seconds)
    d.release()
    return d


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_online_control_fails_and_program_passes(card, seed):
    from benchmark.drivers.online_ensemble import compare
    d = _driver("gan64_online", seed, 5.0)
    limits = manifest.limits("gan64_online")["limits"]
    assert not _fails(d.check(), limits)
    jobs = [d.jobs[i] for i in d.sample()]
    assert _fails(compare(d.reference(jobs, "tf32"), d.reference(jobs)),
                  limits)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails_and_program_passes(card, seed):
    from benchmark.drivers.training import compare
    d = _driver("vae64_train", seed, 0.0)
    limits = manifest.limits("vae64_train")["limits"]
    assert not _fails(d.check(), limits)
    losses, grads, state = d.reference("tf32")
    assert _fails(compare(losses, grads, d.start, state, *d.reference()),
                  limits)
