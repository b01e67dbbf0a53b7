"""The port's drivers beyond `run_ensemble` (`run_simulation`,
`advance_run`, `run_with_snapshots`, `run_ensemble_segmented`) and its bench
entry point, on the CPU: their Datasets against the JAX twin's (mirroring
tests/test_sim.py:43, :59, :65, :85 and :179), and the drivers against each
other, bitwise. Torch cannot reproduce JAX's threefry draws, so the twin is
compared unforced or under a closure that reads no noise."""
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from pyqg_generative_torch.models import cgan_regression, load_model
from pyqg_generative_torch.models.base import \
    Parameterization as TParameterization
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim import advance_run, init_run_carry, \
    run_ensemble, run_ensemble_segmented, run_simulation, \
    run_with_snapshots, set_initial_condition
from pyqg_generative_tpu.models.base import \
    Parameterization as JParameterization
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# 16^2, 8 steps, diagnostics every step, 2 snapshots
KW = dict(nx=16, dt=14400.0, tmax=8 * 14400.0, tavestart=0.0,
          taveint=14400.0, precision="double")
SNAP = 4 * 14400.0
RATE = 1e-6  # s^-1, the damping closure's


class JDamping(JParameterization):
    """The twin's closure -RATE*q: it reads no noise, so both packages
    force alike."""

    def predict_snapshot(self, q, noise):
        return -RATE * q


class TDamping(TParameterization):
    def predict_snapshot(self, q, noise):
        return -RATE * q


class TNull(TParameterization):
    """Zero forcing on two channels of drawn noise (tests/test_sim.py:19)."""

    def latent_shape(self, ny, nx):
        return (ny, nx, 2)

    def generate_latent_noise(self, generator, ny, nx, batch_shape=()):
        return torch.randn(tuple(batch_shape) + (ny, nx, 2),
                           generator=generator, dtype=torch.float64)

    def predict_snapshot(self, q, noise):
        return torch.zeros_like(q)


class TTiny(TNull):
    """Forcing 1e-12 * noise, level first (tests/test_sim.py:34)."""

    def predict_snapshot(self, q, noise):
        return 1e-12 * noise.movedim(-1, -3).to(q.dtype)


FROZEN = {"self": TTiny(), "sampling": "AR1", "nsteps": -1}


def _same_contract(t, j):
    """The port's Dataset has the twin's variables, dims, coordinates,
    shapes, dtypes, time values and units, and pyqg_params."""
    assert sorted(t.keys()) == sorted(j.keys())
    for k in j.keys():
        assert (t[k].dims, t[k].shape, t[k].dtype) == \
            (j[k].dims, j[k].shape, j[k].dtype), k
        assert sorted(t[k].coords) == sorted(j[k].coords), k
        for c in j[k].coords:
            np.testing.assert_array_equal(t[k].coords[c], j[k].coords[c])
    np.testing.assert_array_equal(t["time"].values, j["time"].values)
    assert t["time"].attrs == j["time"].attrs == {"units": "days"}
    assert t.attrs["pyqg_params"] == j.attrs["pyqg_params"]


def _close_to_twin(t, j):
    """q, u, v, psi to 1e-10 of max|q| and each diagnostic to 1e-9 of its
    max: float64 FFTs summed in another order (both stored as float32)."""
    scale = np.abs(j["q"].values).max()
    for k in ("q", "u", "v", "psi"):
        np.testing.assert_allclose(t[k].values, j[k].values, rtol=0,
                                   atol=1e-10 * scale, err_msg=k)
    for k in j.keys():
        if j[k].dims[-2:] == ("l", "k"):
            ref = j[k].values
            np.testing.assert_allclose(t[k].values, ref, rtol=0,
                                       atol=1e-9 * np.abs(ref).max(),
                                       err_msg=k)


def _equal(a, b, keys=None):
    for k in keys or a.keys():
        np.testing.assert_array_equal(a[k].values, b[k].values, err_msg=k)


@pytest.mark.parametrize("closure", ["unforced", "damped", "q_init"])
def test_run_simulation_matches_twin(closure):
    """run_simulation, one member in float64 from the same numpy initial
    condition (or the same `q_init`, tests/test_sim.py:59), against the
    twin: the Dataset contract key by key (with a closure, paramspec and
    paramspec_KEflux too), q to 1e-10 of max|q| and the diagnostics to 1e-9
    of each key's max (FFT rounding). Measured: q, u, v and psi equal
    bitwise after the float32 cast, the diagnostics within 2.9e-19
    (unforced), 3.3e-19 (damped) and 0 (q_init) of each key's max."""
    tp, jp = TParams(**KW), JParams(**KW)
    tc = {"self": TDamping()} if closure == "damped" else None
    jc = {"self": JDamping()} if closure == "damped" else None
    q0 = 1e-6 * np.random.default_rng(9).standard_normal((2, 16, 16)) \
        if closure == "q_init" else None
    t = run_simulation(tp, tc, q_init=q0, sampling_freq=SNAP, key=2,
                       device="cpu")
    j = jsim.run_simulation(jp, jc, q_init=q0, sampling_freq=SNAP, key=2)
    _same_contract(t, j)
    assert t["q"].dims == ("time", "lev", "y", "x")
    assert t["KEspec"].dims == ("lev", "l", "k")
    assert ("paramspec_KEflux" in t) == (closure == "damped")
    _close_to_twin(t, j)


def test_run_ensemble_segmented_matches_twin():
    """run_ensemble_segmented, 2 members in 2 segments with the damping
    closure, against the twin's: the same contract with a `run` dim, and
    the same bars as run_simulation's. Measured: the fields equal bitwise,
    the diagnostics within 7.0e-17 of each key's max."""
    tp, jp = TParams(**KW), JParams(**KW)
    t = run_ensemble_segmented(tp, {"self": TDamping()}, n_ens=2,
                               sampling_freq=SNAP, key=1, n_segments=2,
                               device="cpu")
    j = jsim.run_ensemble_segmented(jp, {"self": JDamping()}, n_ens=2,
                                    sampling_freq=SNAP, key=1, n_segments=2)
    _same_contract(t, j)
    assert t["q"].dims == ("run", "time", "lev", "y", "x")
    _close_to_twin(t, j)


def test_run_ensemble_segmented_members_differ():
    """Three members from their own initial conditions stay apart, under a
    `run` dim (tests/test_sim.py:85)."""
    ds = run_ensemble_segmented(TParams(**KW), n_ens=3, sampling_freq=SNAP,
                                with_diags=False, n_segments=2,
                                device="cpu")
    assert ds["q"].dims == ("run", "time", "lev", "y", "x")
    assert ds["q"].shape == (3, 2, 2, 16, 16)
    assert not np.allclose(ds["q"].values[0], ds["q"].values[1])


def test_null_forcing_equals_unforced():
    """A closure that forces nothing, sampled AR1, leaves the solution as
    the unforced run's (tests/test_sim.py:65), here bitwise."""
    p = TParams(**KW)
    ds0 = run_simulation(p, sampling_freq=SNAP, with_diags=False, key=1,
                         device="cpu")
    ds1 = run_simulation(p, {"self": TNull(), "sampling": "AR1",
                             "nsteps": 1}, sampling_freq=SNAP,
                         with_diags=False, key=1, device="cpu")
    _equal(ds0, ds1, ("q", "u", "v", "psi"))


@pytest.mark.parametrize("closure", [None, FROZEN], ids=["none", "frozen"])
def test_advance_run_twice_equals_run_simulation(closure):
    """Two advances of one snapshot from init_run_carry equal one
    run_simulation of two, bitwise: the snapshots, the second segment's
    running diagnostics, and its time coordinate, shifted by the carry's
    starting step."""
    p = TParams(**KW)
    whole = run_simulation(p, closure, sampling_freq=SNAP, key=3,
                           device="cpu")
    model = closure["self"] if closure else None
    carry = init_run_carry(p, set_initial_condition(p, 3), 3, model,
                           device="cpu")
    segs = []
    for _ in range(2):
        carry, ds = advance_run(carry, p, closure, n_snaps=1,
                                sampling_freq=SNAP, device="cpu")
        segs.append(ds)
    assert carry[0].tc == 8 and carry[0].t == 8 * 14400.0
    for i, ds in enumerate(segs):
        assert ds["q"].dims == ("time", "lev", "y", "x")
        np.testing.assert_array_equal(ds["time"].values,
                                      whole["time"].values[i:i + 1])
        np.testing.assert_array_equal(ds["q"].coords["time"],
                                      whole["time"].values[i:i + 1])
        for k in ("q", "u", "v", "psi"):
            np.testing.assert_array_equal(ds[k].values[0],
                                          whole[k].values[i], err_msg=k)
    _equal(segs[1], whole, [k for k in whole.keys()
                            if k not in ("q", "u", "v", "psi", "time")])


@pytest.mark.parametrize("closure", [None, FROZEN], ids=["none", "frozen"])
def test_run_with_snapshots_equals_run_simulation(closure):
    """run_with_snapshots yields (t seconds, the newest snapshot) per
    interval, equal to run_simulation's snapshots bitwise, and after the
    last, its diagnostics."""
    p = TParams(**KW)
    whole = run_simulation(p, closure, sampling_freq=SNAP, key=4,
                           device="cpu")
    out = list(run_with_snapshots(p, closure, sampling_freq=SNAP, key=4,
                                  device="cpu"))
    assert [t for t, _ in out] == [SNAP, 2 * SNAP]
    for i, (_, ds) in enumerate(out):
        assert ds["q"].shape == (1, 2, 16, 16)
        for k in ("q", "u", "v", "psi"):
            np.testing.assert_array_equal(ds[k].values[0],
                                          whole[k].values[i], err_msg=k)
    _equal(out[-1][1], whole, [k for k in whole.keys()
                               if k not in ("q", "u", "v", "psi", "time")])


@pytest.mark.parametrize("closure", [None, FROZEN], ids=["none", "frozen"])
def test_run_ensemble_segmented_equals_run_ensemble(closure):
    """Two segments of one carry equal the single run: q, u and v bitwise,
    KEspec at rtol 1e-6 (tests/test_sim.py:179)."""
    p = TParams(**{**KW, "precision": "single"})
    a = run_ensemble(p, closure, n_ens=2, sampling_freq=SNAP, key=3,
                     device="cpu")
    b = run_ensemble_segmented(p, closure, n_ens=2, sampling_freq=SNAP,
                               key=3, n_segments=2, device="cpu")
    _equal(a, b, ("q", "u", "v"))
    np.testing.assert_allclose(a["KEspec"].values, b["KEspec"].values,
                               rtol=1e-6)


def test_bench_torch_prints_bench_keys(capsys, monkeypatch):
    """bench_torch.main on the CPU at 16^2 prints one JSON line with
    bench.py's keys, for the GAN eddy_gan_64; a missing folder raises."""
    monkeypatch.syspath_prepend(str(ROOT))
    bench_torch = importlib.import_module("bench_torch")
    bench_torch.main(["--cpu", "--nx", "16", "--members", "2", "--steps",
                      "4", "--snap-every", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert sorted(out) == ["metric", "unit", "value", "vs_baseline"]
    assert out["metric"] == "gan_online_member_steps_per_s_16sq_2member"
    assert out["unit"] == "member-steps/s" and out["value"] > 0
    with pytest.raises(FileNotFoundError):
        bench_torch.main(["--cpu", "--model-folder", "/nonexistent"])


def test_mean_snapshot_draws_once():
    """The deterministic sampler's GAN closure, given no generator, averages
    the draws of a generator seeded with 0, drawn once for all later calls
    (a captured step may draw nothing from a generator it was not given):
    equal, bitwise, to the same call handed that generator."""
    model = load_model(str(ROOT / "trained_models" / "eddy_gan_64"),
                       device="cpu")
    q = torch.from_numpy(1e-5 * np.random.default_rng(8).standard_normal(
        (2, 2, 16, 16)).astype(np.float32))
    cgan_regression._seed0_draws.cache_clear()
    first = model.predict_mean_snapshot(q, M=2)
    again = model.predict_mean_snapshot(q, M=2)
    ref = model.predict_mean_snapshot(
        q, M=2, generator=torch.Generator().manual_seed(0))
    info = cgan_regression._seed0_draws.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert torch.equal(first, ref) and torch.equal(again, ref)
