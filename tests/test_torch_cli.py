"""The port's experiment CLI (`python -m pyqg_generative_torch.exp.cli`)
against the JAX twin's, subcommand by subcommand, on the CPU (`--device
cpu`), at 16^2-32^2 in float64 (the twin's tests/test_pipeline.py:81-167):
`reference`, `forcing`, `forecast` and `metrics` write the twin's files to
the tolerances of tests/test_torch_drivers.py and
tests/test_torch_forcing.py; `parameterized` runs a physical closure by
name as the twin does, and `--model-weight` scales its forcing, where the
twin's leaves a physical closure unweighted (ROADMAP, queue 3); `train`
writes the twin's folder contract, which the twin's `load_model` reads and
the port's `parameterized` runs as the twin's does."""
import json
import os

import numpy as np
import pytest
import torch

from pyqg_generative_torch.exp import cli as tcli
from pyqg_generative_torch.models import Laplace
from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_tpu.exp import cli as jcli
from pyqg_generative_tpu.models import load_model as jload_model
from pyqg_generative_tpu.models.physical import Laplace as JLaplace
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.utils import xrlite as jxr

from test_torch_drivers import _close_to_twin, _same_contract

torch.set_num_threads(1)

DT = 14400.0
DOUBLE = json.dumps({"dt": DT, "tmax": 8 * DT, "tavestart": 4 * DT,
                     "precision": "double"})
SNAP = str(4 * DT)


def _both(tmp_path, argv, name):
    """Run argv through both CLIs into <tmp>/<name>_{port,twin}, the port
    on the CPU; the two output folders."""
    out = {}
    for pkg, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                             ("twin", jcli.main, [])):
        folder = str(tmp_path / f"{name}_{pkg}")
        main(argv + ["--subfolder", folder] + extra)
        out[pkg] = folder
    return out["port"], out["twin"]


def _read(folder, xr, f):
    return xr.Dataset.from_npz(os.path.join(folder, f))


def test_help_lists_the_six_subcommands(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for sub in ("reference", "forcing", "parameterized", "forecast", "train",
                "metrics"):
        assert sub in text
    assert "online-backend" not in text


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """`reference` of 2 members at 16^2 from both CLIs."""
    return _both(tmp_path_factory.mktemp("reference"),
                 ["reference", "--nx", "16", "--params", DOUBLE,
                  "--sampling-freq", SNAP, "--n-ens", "2"], "ref")


@pytest.mark.parametrize("f", ["0.npz", "1.npz"])
def test_reference_matches_twin(reference, f):
    """Each member of the ensemble: the twin's contract, q to 1e-10 of
    max|q|, the diagnostics to 1e-9 of each one's max."""
    port, twin = (_read(d, xr, f) for d, xr in zip(reference, (txr, jxr)))
    _same_contract(port, twin)
    _close_to_twin(port, twin)


def test_reference_member_matches_twin(tmp_path):
    """One member (`--ensemble-member 1`, run_simulation with key 1)."""
    port, twin = _both(tmp_path, ["reference", "--nx", "16", "--params",
                                  DOUBLE, "--sampling-freq", SNAP,
                                  "--ensemble-member", "1"], "member")
    assert os.listdir(port) == os.listdir(twin) == ["1.npz"]
    _close_to_twin(_read(port, txr, "1.npz"), _read(twin, jxr, "1.npz"))


@pytest.fixture(scope="module")
def forcing(tmp_path_factory):
    """`forcing` of members 0..3, a 32^2 DNS coarse-grained to 16^2, from
    the port's CLI; member 1 also from the twin's."""
    root = tmp_path_factory.mktemp("forcing")
    argv = ["forcing", "--nx", "32", "--params",
            json.dumps({"dt": 3600.0, "tmax": 20 * 3600.0,
                        "precision": "double"}),
            "--sampling-freq", str(10 * 3600.0), "--nc", "[16]",
            "--subfolder", str(root)]
    for member in range(4):
        tcli.main(argv + ["--ensemble-member", str(member), "--device",
                          "cpu"])
    jcli.main(argv[:-1] + [str(root / "twin"), "--ensemble-member", "1"])
    return root


def test_forcing_matches_twin(forcing):
    """Member 1's dataset of each default operator at rtol 1e-10."""
    for combo in ("Operator2-16-dealias", "Operator5-16-dealias"):
        port = _read(forcing / combo, txr, "1.npz")
        twin = _read(forcing / "twin" / combo, jxr, "1.npz")
        assert sorted(port.keys()) == sorted(twin.keys())
        for k in ("q_forcing_advection", "q", "u", "v", "psi"):
            ref = twin[k].values
            np.testing.assert_allclose(port[k].values, ref, rtol=1e-10,
                                       atol=1e-12 * np.abs(ref).max())


LAPLACE = ["parameterized", "--nx", "16", "--params", DOUBLE,
           "--sampling-freq", SNAP, "--closure", "Laplace",
           "--sampling", "deterministic"]


def _nu(nu):
    return ["--closure-args", json.dumps({"nu": nu, "PV": True})]


def test_parameterized_physical_closure_matches_twin(tmp_path):
    """A physical closure by registry name, deterministic: the twin's run."""
    port, twin = _both(tmp_path, LAPLACE + _nu(50.0), "lap")
    p, j = _read(port, txr, "0.npz"), _read(twin, jxr, "0.npz")
    _same_contract(p, j)
    _close_to_twin(p, j)
    assert "paramspec" in p


def test_model_weight_reaches_physical_closures(tmp_path):
    """`--model-weight 0.5` on Laplace(nu=50) is, in the port, the run of
    Laplace(nu=25), bit for bit (halving is exact); in the twin it is the
    unweighted run of nu=50, bit for bit, since the twin's weight wraps
    `predict_snapshot`, which a physical closure's online hook never
    calls."""
    half = ["--model-weight", "0.5"]
    port_w, twin_w = _both(tmp_path, LAPLACE + _nu(50.0) + half, "w")
    port_25, _ = _both(tmp_path, LAPLACE + _nu(25.0), "nu25")
    _, twin_50 = _both(tmp_path, LAPLACE + _nu(50.0), "nu50")
    pw, p25 = _read(port_w, txr, "0.npz"), _read(port_25, txr, "0.npz")
    for k in pw.keys():
        np.testing.assert_array_equal(pw[k].values, p25[k].values, k)
    tw, t50 = _read(twin_w, jxr, "0.npz"), _read(twin_50, jxr, "0.npz")
    for k in tw.keys():
        np.testing.assert_array_equal(tw[k].values, t50[k].values, k)
    assert np.abs(pw["q"].values - tw["q"].values).max() > \
        1e-6 * np.abs(tw["q"].values).max()


def test_weighted_hooks_scale_the_forcing():
    """The online hooks of the weighted closure: the port's are w times the
    unweighted forcing; the twin's `_weighted` leaves Laplace's at the
    unweighted one."""
    p = TParams(nx=16, precision="double")
    q = tcore.default_initial_q(p, rng=np.random.default_rng(3)).double()
    flds = tcore.fields(tcore.rfft2(q), p)
    model = Laplace(nu=50.0, PV=True, device="cpu")
    f1 = model.online_forcing(flds, None, p)
    fw = tcli.Weighted(model, 0.25).online_forcing(flds, None, p)
    torch.testing.assert_close(fw, 0.25 * f1, rtol=0, atol=0)
    torch.testing.assert_close(
        tcli.Weighted(model, 0.25).online_mean_forcing(flds, p),
        0.25 * model.online_mean_forcing(flds, p), rtol=0, atol=0)
    jp = JParams(nx=16, precision="double")
    jflds = jcore.fields(jcore._rfft2(q.numpy()), jp)
    jmodel = JLaplace(nu=50.0, PV=True)
    j1 = np.asarray(jmodel.online_forcing(jflds, None, jp))
    jw = np.asarray(jcli._weighted(jmodel, 0.25).online_forcing(jflds, None,
                                                                 jp))
    np.testing.assert_array_equal(jw, j1)
    np.testing.assert_allclose(f1.numpy(), j1, rtol=1e-10,
                               atol=1e-12 * np.abs(j1).max())


def test_forecast_matches_twin(reference, tmp_path):
    """`forecast` of 3 members from member 0's last snapshot, no model, 2
    days daily: member 0, mean and std to 1e-10 of each one's max."""
    ic = os.path.join(reference[0], "0.npz")
    port, twin = _both(tmp_path, [
        "forecast", "--nx", "16", "--params",
        json.dumps({"dt": DT, "tmax": 2 * 86400.0, "precision": "double"}),
        "--initial-condition", ic, "--n-ens", "3", "--number", "4"], "fc")
    p, j = _read(port, txr, "4.npz"), _read(twin, jxr, "4.npz")
    assert sorted(p.keys()) == sorted(j.keys())
    for k in j.keys():
        ref = j[k].values
        np.testing.assert_allclose(p[k].values, ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=k)
    assert j["q"].sizes()["time"] == 2


def test_metrics_matches_twin(reference, tmp_path):
    """`metrics` of the ensemble against one member: every difference at
    rtol 1e-10, and the key."""
    out = {}
    for pkg, main in (("port", tcli.main), ("twin", jcli.main)):
        save = str(tmp_path / f"{pkg}.json")
        main(["metrics", "--model-path", os.path.join(reference[0], "*.npz"),
              "--target-path", os.path.join(reference[0], "0.npz"),
              "--save-file", save, "--T", "2", "--key-name", "self"])
        with open(save) as f:
            out[pkg] = json.load(f)
    assert sorted(out["port"]) == sorted(out["twin"])
    assert out["port"]["key"] == "self"
    for k, v in out["twin"].items():
        if k != "key":
            np.testing.assert_allclose(out["port"][k], v, rtol=1e-10,
                                       err_msg=k)


def test_train_then_parameterized(forcing, tmp_path):
    """`train` of an 8-wide OLS on members 0..3 (splits 0, 2, 3, 4) writes
    the twin's folder contract and offline_test.npz, which the twin's
    `load_model` reads; `parameterized` of that folder, 2 members in
    float32, is the twin's run to 2e-5 of max|q|."""
    folder = str(tmp_path / "model")
    tcli.main(["train", "--model", "OLSModel",
               "--model-args", json.dumps({"hidden_channels": [8, 8]}),
               "--fit-args", json.dumps({"num_epochs": 2, "batch_size": 8,
                                         "verbose": False}),
               "--model-folder", folder, "--train-path",
               str(forcing / "Operator2-16-dealias" / "*.npz"),
               "--splits", "[0,2,3,4]", "--ensemble-size", "2",
               "--device", "cpu"])
    with open(os.path.join(folder, "model_args.json")) as f:
        args = json.load(f)
    assert (args["model"], args["hidden_channels"]) == ("OLSModel", [8, 8])
    offline = _read(folder, txr, "offline_test.npz")
    assert offline["q"].sizes()["run"] == 1
    assert type(jload_model(folder)).__name__ == "OLSModel"
    port, twin = _both(tmp_path, [
        "parameterized", "--nx", "16", "--params",
        json.dumps({"dt": DT, "tmax": 8 * DT, "tavestart": 4 * DT}),
        "--sampling-freq", SNAP, "--model-folder", folder, "--n-ens", "2"],
        "ols")
    for f in ("0.npz", "1.npz"):
        p, j = _read(port, txr, f), _read(twin, jxr, f)
        _same_contract(p, j)
        q = j["q"].values
        np.testing.assert_allclose(p["q"].values, q, rtol=0,
                                   atol=2e-5 * np.abs(q).max())
