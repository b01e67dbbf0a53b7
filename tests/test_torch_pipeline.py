"""The port's experiment pipeline (`exp/pipeline.py`) against the JAX
twin's, stage by stage, on the CPU at 16^2-32^2:

- `run_reference`, unforced, in float64 with the same keys: each member's
  file to 1e-10 of max|q| (`tests/test_torch_drivers.py::_close_to_twin`);
- `run_forcing_datasets` at the twin's operators (Operator2, Operator5),
  rtol 1e-10 (`tests/test_torch_forcing.py`); runs advanced together equal
  the one-run call's; the port's default operators feed
  `train_parameterizations`, the twin's do not (ROADMAP, queue 3);
- `run_parameterized` under a closure that reads no noise (seeded OLS
  weights the port writes and both packages load), in float32, to 2e-5 of
  max|q| (`tests/test_torch_zoo.py`'s online bar);
- `coarse_target_cached`: each package reads the other's cache;
- `compute_online_metrics` on the same files: rtol 1e-10;
- `forecast_initial_conditions`, and `run_forecasting` and
  `run_forecast_truth` with no model in float64;
- `train_parameterizations` and `train_ANN`: the splits, the folder
  contract, the skip, `fit`'s keys, and the twin's `load_model` reading a
  folder the port trained.

The float64 runs come from the configuration's preset with
`precision="double"` in both packages (their `CONFIGURATIONS`), and the
truth run, which the pipeline pins to single precision, from each
package's `run_ensemble` wrapped to run it in double.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pyqg_generative_torch.exp import pipeline as tpipe
from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml.weights import params_to_jax, \
    seeded_variables
from pyqg_generative_torch.models import save_model_args, save_variables
from pyqg_generative_torch.qg.params import YEAR
from pyqg_generative_torch.sim import generate_subgrid_forcing
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_tpu.exp import pipeline as jpipe
from pyqg_generative_tpu.models import base as jbase
from pyqg_generative_tpu.utils import xrlite as jxr

from test_torch_drivers import _close_to_twin, _same_contract
from test_torch_train import assert_tree_close

torch.set_num_threads(1)

DT = 14400.0                    # dt_for_nx at 16^2 and 32^2
SNAP = 4 * DT
YEARS = 8.5 * DT / YEAR         # 2 snapshots of 4 steps, diagnostics
#                                 from step 5
HI, LO = 32, 16
HID = (8, 8)
SCALERS = "trained_models/eddy_gan_64"


def _double(pipeline, monkeypatch):
    monkeypatch.setitem(pipeline.CONFIGURATIONS, "eddy",
                        pipeline.CONFIGURATIONS["eddy"].replace(
                            precision="double"))


def _close(out, ref, rtol=1e-10):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _members(folder, xr):
    return {f: xr.Dataset.from_npz(os.path.join(folder, f))
            for f in sorted(os.listdir(folder)) if f.endswith(".npz")}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Each package's float64 reference, 2 members at 32^2:
    {package: its reference_32 folder}."""
    out = {}
    for name, pipe in (("port", tpipe), ("twin", jpipe)):
        base = str(tmp_path_factory.mktemp(f"ref_{name}"))
        kw = dict(device="cpu") if name == "port" else {}
        with pytest.MonkeyPatch.context() as mp:
            _double(pipe, mp)
            pipe.run_reference(base, resolutions=(HI,), n_ens=2,
                               years=YEARS, sampling_freq=SNAP, **kw)
        out[name] = os.path.join(base, "eddy", f"reference_{HI}")
    return out


def test_run_reference_matches_twin(refs):
    """Each member's file: the twin's Dataset contract, q, u, v, psi to
    1e-10 of max|q| and the diagnostics to 1e-9 of each one's max."""
    port, twin = _members(refs["port"], txr), _members(refs["twin"], jxr)
    assert sorted(port) == sorted(twin) == ["0.npz", "1.npz"]
    for f in twin:
        _same_contract(port[f], twin[f])
        _close_to_twin(port[f], twin[f])
        assert port[f]["q"].shape == (2, 2, HI, HI)


# ----------------------------------------------------------- forcing data

FORCING = dict(Nc=(LO,), dns_nx=HI, years=YEARS, sampling_freq=SNAP)
TWIN_OPS = ("Operator2", "Operator5")


@pytest.fixture(scope="module")
def forcing(tmp_path_factory):
    """6 forcing runs at the twin's operators from each package, the port's
    one run and 3 runs a batch: {name: base}."""
    out = {}
    for name, pipe, kw in (
            ("twin", jpipe, {}),
            ("port", tpipe, dict(operators=TWIN_OPS, batch=1,
                                 device="cpu")),
            ("batched", tpipe, dict(operators=TWIN_OPS, batch=3,
                                    device="cpu"))):
        base = str(tmp_path_factory.mktemp(f"forcing_{name}"))
        with pytest.MonkeyPatch.context() as mp:
            _double(pipe, mp)
            pipe.run_forcing_datasets(base, n_runs=6, **FORCING, **kw)
        out[name] = base
    return out


def _combo(base, op):
    return os.path.join(base, "eddy", f"{op}-{LO}-dealias")


def test_forcing_datasets_match_twin(forcing):
    """Every run's file of each (operator, resolution): the twin's
    variables, dims and attributes, each array at rtol 1e-10 (float64 FFTs
    of two libraries, stored as float32)."""
    for op in TWIN_OPS:
        port = _members(_combo(forcing["port"], op), txr)
        twin = _members(_combo(forcing["twin"], op), jxr)
        assert sorted(port) == sorted(twin) == [f"{r}.npz" for r in range(6)]
        for f, ref in twin.items():
            assert sorted(port[f].keys()) == sorted(ref.keys())
            assert port[f].attrs == ref.attrs
            for v in ("q_forcing_advection", "q", "u", "v", "psi"):
                assert port[f][v].dims == ref[v].dims
                _close(port[f][v].values, ref[v].values)


def test_forcing_batched_equals_one_run(forcing, monkeypatch):
    """Runs advanced 3 at a time write, for each run, the datasets of the
    one-run call `generate_subgrid_forcing` with its key, at rtol 1e-10;
    the runs differ."""
    _double(tpipe, monkeypatch)
    p = tpipe.CONFIGURATIONS["eddy"].with_nx(HI).replace(tmax=YEARS * YEAR)
    for r in (0, 4):
        one = generate_subgrid_forcing([LO], p, SNAP, operators=TWIN_OPS,
                                       key=r, device="cpu")
        for op in TWIN_OPS:
            batched = txr.Dataset.from_npz(
                os.path.join(_combo(forcing["batched"], op), f"{r}.npz"))
            ref = one[f"{op}-{LO}-dealias"]
            for v in ("q_forcing_advection", "q", "u", "v", "psi"):
                _close(batched[v].values, ref[v].values)
    q = [txr.Dataset.from_npz(os.path.join(
        _combo(forcing["batched"], "Operator2"), f"{r}.npz"))["q"].values
        for r in (0, 3)]
    assert not np.allclose(q[0], q[1])


def test_default_operators_chain_into_training(tmp_path, monkeypatch):
    """The port's forcing stage writes, by default, the Operator1 and
    Operator2 folders that `train_parameterizations` reads by default; the
    twin's writes Operator2 and Operator5, and its training stage then
    finds no Operator1 data and fails on an empty list of runs (ROADMAP,
    queue 3)."""
    fit_calls = []
    monkeypatch.setitem(tpipe.MODEL_REGISTRY, "Stub", _stub(fit_calls))
    port, twin = str(tmp_path / "port"), str(tmp_path / "twin")
    tpipe.run_forcing_datasets(port, n_runs=2, device="cpu", **FORCING)
    jpipe.run_forcing_datasets(twin, n_runs=2, **FORCING)
    assert sorted(os.listdir(os.path.join(port, "eddy"))) == [
        f"Operator1-{LO}-dealias", f"Operator2-{LO}-dealias"]
    assert sorted(os.listdir(os.path.join(twin, "eddy"))) == [
        f"Operator2-{LO}-dealias", f"Operator5-{LO}-dealias"]
    tpipe.train_parameterizations(port, models=("Stub",), resolutions=(LO,),
                                  realizations=1, device="cpu")
    assert [c["op"] for c in fit_calls] == ["Operator1", "Operator2"]
    with pytest.raises(IndexError):
        jpipe.train_parameterizations(twin, models=("MeanVarModel",),
                                      resolutions=(LO,), realizations=1)


def _stub(calls):
    """A registry entry that records how the training stage builds and fits
    it, and writes the folder's model_args.json."""
    class Stub:
        def __init__(self, folder, device=None, **kw):
            self.folder, self.kw = folder, kw

        def fit(self, ds_train, ds_val, **kw):
            calls.append({"op": self.folder.split("models_")[1].split("_")[0],
                          "kw": kw, "ctor": self.kw,
                          "runs": (ds_train["q"].sizes()["run"],
                                   ds_val["q"].sizes()["run"])})
            save_model_args("Stub", folder=self.folder)

        def test_offline(self, ds, ensemble_size):
            calls[-1]["test_runs"] = ds["q"].sizes()["run"]
            calls[-1]["ensemble_size"] = ensemble_size
            return txr.Dataset()
    return Stub


@pytest.mark.parametrize("nrun", [1, 2, 6, 12, 299, 300])
def test_run_splits_are_the_twins(nrun):
    """The train, validation and test runs of `nrun` (twin :76-80)."""
    cuts = [int(f * nrun) for f in (0.0, 0.833, 0.917, 1.0)]
    assert tpipe.run_splits(nrun) == [slice(cuts[0], cuts[1]),
                                      slice(cuts[1], cuts[2]),
                                      slice(cuts[2], cuts[3])]


def test_train_parameterizations_trains_and_skips(forcing, monkeypatch):
    """The GZ, GAN and VAE on 6 runs (4 train, 1 validate, 1 test), one
    epoch each, their nets 8 wide: each folder holds the twin's
    contract and offline_test.npz on the test run; the GAN and the VAE
    were fitted with key = seed, GZ without one; the twin's `load_model`
    reads the GZ folder and its `load_variables` the GAN's generator and
    the VAE's decoder (its `load_model` would run flax's `init` of each
    net, 20 s on the CPU); a second call skips every folder with a
    model_args.json."""
    base = forcing["port"]
    monkeypatch.setattr(tpipe, "MODEL_REGISTRY", dict(tpipe.MODEL_REGISTRY))
    keys = {}
    for name in ("MeanVarModel", "CGANRegression", "CVAERegression"):
        cls = tpipe.MODEL_REGISTRY[name]

        def init(self, *a, _cls=cls, **kw):
            _cls.__init__(self, *a, hidden_channels=HID, **kw)

        def fit(self, *a, _cls=cls, _name=name, **kw):
            keys[_name] = kw.get("key")
            return _cls.fit(self, *a, **kw)
        tpipe.MODEL_REGISTRY[name] = type(name, (cls,), {"__init__": init,
                                                          "fit": fit})
    fit_kw = dict(num_epochs=1, batch_size=8, verbose=False)
    tpipe.train_parameterizations(
        base, operators=("Operator2",), resolutions=(LO,), realizations=1,
        fit_kw=dict(fit_kw, nruns=1), ensemble_size=4, device="cpu")
    assert keys == {"MeanVarModel": None, "CGANRegression": 0,
                    "CVAERegression": 0}
    root = os.path.join(base, "eddy", f"models_Operator2_{LO}")
    assert sorted(os.listdir(root)) == ["CGANRegression-0",
                                        "CVAERegression-0", "MeanVarModel-0"]
    for folder in sorted(os.listdir(root)):
        path = os.path.join(root, folder)
        offline = txr.Dataset.from_npz(os.path.join(path, "offline_test.npz"))
        assert offline["q"].sizes()["run"] == 1
        assert np.isfinite(offline["L2_mean"].values).all()
        port = tpipe.load_model(path, device="cpu")
        assert type(port).__name__ == folder.split("-")[0]
    twin = jpipe.load_model(os.path.join(root, "MeanVarModel-0"))
    assert type(twin).__name__ == "MeanVarModel"
    for folder, net, fname in (("CGANRegression-0", "G", "G"),
                               ("CVAERegression-0", "decoder", "decoder")):
        port = tpipe.load_model(os.path.join(root, folder), device="cpu")
        module = getattr(port, net)
        got = jbase.load_variables(seeded_variables(module, 0), os.path.join(
            root, folder, f"{fname}.msgpack"))
        assert_tree_close(got, params_to_jax(module.state_dict()), 0)
    mtimes = {f: os.stat(os.path.join(root, f, "model_args.json")).st_mtime_ns
              for f in os.listdir(root)}
    for name in keys:
        keys[name] = "not called"
    tpipe.train_parameterizations(
        base, operators=("Operator2",), resolutions=(LO,), realizations=1,
        fit_kw=fit_kw, device="cpu")
    assert set(keys.values()) == {"not called"}
    assert mtimes == {
        f: os.stat(os.path.join(root, f, "model_args.json")).st_mtime_ns
        for f in os.listdir(root)}


def test_train_ann_folder(forcing, tmp_path):
    """The ANN on the eddy data alone: trained on the first 90% of the runs
    (5 of 6), scored offline on the rest into offline_eddy-16.npz; the
    twin's `load_model` reads the folder."""
    base = str(tmp_path)
    shutil.copytree(os.path.join(forcing["port"], "eddy"),
                    os.path.join(base, "eddy"))
    model = tpipe.train_ANN(base, configurations=("eddy",),
                            resolutions=(LO,), operator="Operator2",
                            fit_kw=dict(num_epochs=1, verbose=False),
                            device="cpu")
    folder = os.path.join(base, "ann_model")
    assert model.folder == folder
    offline = txr.Dataset.from_npz(os.path.join(folder,
                                                f"offline_eddy-{LO}.npz"))
    assert offline["q"].sizes()["run"] == 1
    with open(os.path.join(folder, "model_args.json")) as f:
        assert json.load(f)["model"] == "ANNModel"
    assert type(jpipe.load_model(folder)).__name__ == "ANNModel"


# ----------------------------------------------------------- online stages

@pytest.fixture(scope="module")
def ols_online(refs, tmp_path_factory):
    """A folder of seeded OLS weights (8 wide) written by the port, and each
    package's run_parameterized of it at 16^2, 2 members, float32:
    {package: its folder}."""
    out = {}
    tree = seeded_variables(tnets.AndrewCNN(2, 2, hidden_channels=HID), 50)
    for name, pipe in (("port", tpipe), ("twin", jpipe)):
        folder = tmp_path_factory.mktemp(f"ols_{name}")
        save_variables(tree, str(folder / "net.msgpack"))
        for s in ("x_scale.json", "y_scale.json"):
            shutil.copy(f"{SCALERS}/{s}", folder / s)
        save_model_args("OLSModel", folder=str(folder),
                        hidden_channels=list(HID))
        kw = dict(device="cpu") if name == "port" else {}
        pipe.run_parameterized(str(folder), str(folder), nx=LO, n_ens=2,
                               years=YEARS, sampling_freq=SNAP, **kw)
        out[name] = str(folder)
    return out


def test_run_parameterized_matches_twin(ols_online):
    """Each member's file of the OLS ensemble: the twin's contract, q to
    2e-5 of max|q| (float32 convolutions and FFTs summed in another
    order); the forcing's spectrum is there."""
    port = _members(os.path.join(ols_online["port"], "online"), txr)
    twin = _members(os.path.join(ols_online["twin"], "online"), jxr)
    assert sorted(port) == sorted(twin) == ["0.npz", "1.npz"]
    for f, ref in twin.items():
        _same_contract(port[f], ref)
        assert "paramspec" in port[f]
        q = ref["q"].values
        np.testing.assert_allclose(port[f]["q"].values, q, rtol=0,
                                   atol=2e-5 * np.abs(q).max())


@pytest.mark.parametrize("writer", ["port", "twin"])
def test_coarse_target_cache_read_by_the_other(refs, writer, tmp_path):
    """The coarse-grained reference (Operator1, 16^2) cached by one package
    beside the runs, as .coarse_Operator1_16.npz, is what the other reads
    back, untouched; the two packages' targets agree to float32's rounding
    of the operator (both coarse-grain the float32 snapshots in float32),
    and their spectra exactly."""
    ref = str(tmp_path / "ref")
    shutil.copytree(refs["port"], ref)
    pattern = os.path.join(ref, "*.npz")

    def build(pipe):
        kw = dict(device="cpu") if pipe is tpipe else {}
        return pipe.coarse_target_cached(pattern, "Operator1", LO, **kw)

    first, second = (tpipe, jpipe) if writer == "port" else (jpipe, tpipe)
    made = build(first)
    cache = os.path.join(ref, f".coarse_Operator1_{LO}.npz")
    mtime = os.stat(cache).st_mtime_ns
    read = build(second)
    assert os.stat(cache).st_mtime_ns == mtime
    assert sorted(read.keys()) == sorted(made.keys())
    for k in made.keys():
        np.testing.assert_array_equal(read[k].values, made[k].values)
    os.remove(cache)
    other = build(second)
    for k in made.keys():
        a, b = other[k].values, made[k].values
        rtol = 2e-6 if k in ("q", "u", "v", "psi") else 1e-12
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * np.abs(b).max(), err_msg=k)


def test_compute_online_metrics_matches_twin(refs, ols_online, tmp_path):
    """The port's online runs against the reference's one coarse target:
    every normalized difference, both scores and the key, at rtol 1e-10;
    each package writes the twin's JSON."""
    ref = str(tmp_path / "ref")
    shutil.copytree(refs["port"], ref)
    pattern = os.path.join(ref, "*.npz")
    folder = ols_online["port"]
    port = tpipe.compute_online_metrics(str(tmp_path), folder, pattern,
                                        "Operator1", LO, T=2,
                                        save_file="port.json", device="cpu")
    twin = jpipe.compute_online_metrics(str(tmp_path), folder, pattern,
                                        "Operator1", LO, T=2,
                                        save_file="twin.json")
    assert sorted(port) == sorted(twin)
    assert port["key"] == twin["key"] == os.path.basename(folder)
    for k, v in twin.items():
        if k != "key":
            np.testing.assert_allclose(port[k], v, rtol=1e-10, err_msg=k)
    assert port["distrib_score"] > 0 and port["spectral_score"] > 0
    with open(os.path.join(folder, "port.json")) as f:
        assert json.load(f) == port


# ------------------------------------------------------------- forecasts

def test_forecast_initial_conditions_match_twin(refs):
    """IC j takes run j's last snapshot, coarse-grained to 16^2 by
    Operator2 (in float32 in both packages, as the snapshots are stored);
    ICs past the runs found are skipped."""
    glob_ = os.path.join(refs["port"], "*.npz")
    port = list(tpipe.forecast_initial_conditions(glob_, LO, "Operator2", 3,
                                                  device="cpu"))
    twin = list(jpipe.forecast_initial_conditions(glob_, LO, "Operator2", 3))
    assert [n for n, _ in port] == [n for n, _ in twin] == [0, 1]
    for (_, a), (_, b) in zip(port, twin):
        assert a.shape == b.shape == (2, LO, LO)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6 * np.abs(b).max())


FORECAST = dict(nx=LO, n_ic=2, n_ens=3, decorrelations=(0, 12), days=3.0)


def test_run_forecasting_matches_twin(refs, tmp_path, monkeypatch):
    """No model, float64, 2 ICs x 3 members x 2 decorrelations, from the
    same initial conditions (the twin's): member 0, the mean and std of the
    other members, `n_ens_stat`, each to 1e-10 of its max."""
    glob_ = os.path.join(refs["port"], "*.npz")
    ics = list(jpipe.forecast_initial_conditions(glob_, LO, "Operator2", 2))
    for pipe in (tpipe, jpipe):
        _double(pipe, monkeypatch)
        monkeypatch.setattr(pipe, "forecast_initial_conditions",
                            lambda *a, **k: iter(ics))
    tpipe.run_forecasting(str(tmp_path / "port"), None, glob_,
                          device="cpu", **FORECAST)
    jpipe.run_forecasting(str(tmp_path / "twin"), None, glob_, **FORECAST)
    for dec in FORECAST["decorrelations"]:
        sub = os.path.join("forecast", f"decorrelation-{dec}h")
        port = _members(str(tmp_path / "port" / sub), txr)
        twin = _members(str(tmp_path / "twin" / sub), jxr)
        assert sorted(port) == sorted(twin) == ["0.npz", "1.npz"]
        for f, ref in twin.items():
            assert port[f].attrs["n_ens_stat"] == ref.attrs["n_ens_stat"] == 2
            assert sorted(port[f].keys()) == sorted(ref.keys())
            for k in ref.keys():
                assert port[f][k].dims == ref[k].dims, k
                np.testing.assert_allclose(
                    port[f][k].values, ref[k].values, rtol=0,
                    atol=1e-10 * np.abs(ref[k].values).max(), err_msg=k)
            assert ref["q"].sizes()["time"] == 3


def _run_in_double(pipe, monkeypatch):
    run = pipe.run_ensemble

    def double(p, *a, **k):
        return run(p.replace(precision="double"), *a, **k)
    monkeypatch.setattr(pipe, "run_ensemble", double)


def test_run_forecast_truth_matches_twin(refs, tmp_path, monkeypatch):
    """The 32^2 truth of 2 ICs continued for 3 days in float64, daily,
    coarse-grained to 16^2 by Operator2 in float32 (both coarse-grain the
    float32 snapshots in float32): each variable to 2e-6 of its max; a
    second call keeps the files it finds."""
    glob_ = os.path.join(refs["port"], "*.npz")
    kw = dict(nx=LO, n_ic=2, days=3.0, truth_nx=HI)
    for pipe in (tpipe, jpipe):
        _run_in_double(pipe, monkeypatch)
    tpipe.run_forecast_truth(str(tmp_path / "port"), glob_, device="cpu",
                             **kw)
    jpipe.run_forecast_truth(str(tmp_path / "twin"), glob_, **kw)
    port = _members(str(tmp_path / "port" / "forecast"), txr)
    twin = _members(str(tmp_path / "twin" / "forecast"), jxr)
    assert sorted(port) == sorted(twin) == ["truth_0.npz", "truth_1.npz"]
    for f, ref in twin.items():
        assert port[f].attrs == ref.attrs
        for k in ("q", "u", "v", "psi"):
            assert port[f][k].dims == ref[k].dims == ("time", "lev", "y",
                                                      "x")
            assert port[f][k].shape == (3, 2, LO, LO)
            np.testing.assert_allclose(
                port[f][k].values, ref[k].values, rtol=0,
                atol=2e-6 * np.abs(ref[k].values).max(), err_msg=k)
    path = str(tmp_path / "port" / "forecast" / "truth_0.npz")
    mtime = os.stat(path).st_mtime_ns
    tpipe.run_forecast_truth(str(tmp_path / "port"), glob_, device="cpu",
                             **kw)
    assert os.stat(path).st_mtime_ns == mtime
