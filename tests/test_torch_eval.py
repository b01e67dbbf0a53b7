"""The port's scoring path against the JAX twin's, on the CPU: the copied
numpy modules (`qg/spectral.py`, `eval/metrics.py`, `eval/forecast.py`),
`ml/train.py::apply_in_batches`, each closure's offline `predict` and the
harness `test_offline`, the online comparison (`eval/comparison.py`) and the
port's `entry()`.

The offline data is a forcing dataset of the port's generator (two 32^2
DNS runs in float64, coarse-grained by Operator2 to 16^2, 3 snapshots each;
the twin's is equal to it, tests/test_torch_forcing.py). Random weights are flax trees of
the port's module layouts from `ml.weights.seeded_variables`, at narrow
widths; the twins are built from a missing folder and handed the trees, and
run jitted, so no flax `init` runs. Float32 results are held at rtol 2e-4 /
atol 2e-5*max|ref| (float32 convolutions summed in another order, the bar of
tests/test_pallas_conv.py:49); what both packages compute in float64 or in
the same numpy code at rtol 1e-10 / atol 1e-12*max|ref|."""
import glob
import inspect
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pyqg_generative_torch import entry as tentry
from pyqg_generative_torch.eval import comparison as tcmp
from pyqg_generative_torch.eval import forecast as tforecast
from pyqg_generative_torch.eval import metrics as tmetrics
from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml.train import apply_in_batches
from pyqg_generative_torch.ml.weights import seeded_variables
from pyqg_generative_torch.models import \
    ZannaBolton2020, load_model, save_model_args, save_variables
from pyqg_generative_torch.models.base import extract
from pyqg_generative_torch.qg import core as tcore
from pyqg_generative_torch.qg import spectral as tspectral
from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim import generate_subgrid_forcing_batch, \
    run_simulation
from pyqg_generative_torch.sim.simulate import make_online_step
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_tpu.eval import comparison as jcmp
from pyqg_generative_tpu.eval import metrics as jmetrics
from pyqg_generative_tpu.ml import train as jtrain
from pyqg_generative_tpu.ml.scalers import ChannelwiseScaler
from pyqg_generative_tpu.models import ann_model as jann
from pyqg_generative_tpu.models import cgan_regression as jgan
from pyqg_generative_tpu.models import cvae_bottleneck as jbot
from pyqg_generative_tpu.models import cvae_regression as jvae
from pyqg_generative_tpu.models import mean_var_model as jgz
from pyqg_generative_tpu.models import ols_model as jols
from pyqg_generative_tpu.models import physical as jphys
from pyqg_generative_tpu.qg import core as jcore
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim
from pyqg_generative_tpu.sim import stochastic as jsto
from pyqg_generative_tpu.utils import xrlite as jxr

torch.set_num_threads(1)

MODELS = "trained_models"
SCALERS = f"{MODELS}/eddy_gan_64"
MISSING = "/nonexistent_model_folder"
HID = (16, 8, 8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())


def _exact(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())


def _to_twin(ds, tmp_path, name="ds"):
    """The same Dataset in the twin's xrlite, through its `.npz`."""
    path = str(tmp_path / f"{name}.npz")
    ds.to_npz(path)
    return jxr.Dataset.from_npz(path)


def _scalers(model, folder=SCALERS):
    model.x_scale = ChannelwiseScaler().read("x_scale.json", folder)
    model.y_scale = ChannelwiseScaler().read("y_scale.json", folder)
    return model


def _write_folder(path, name, nets, **args):
    """A model folder of the twin's contract written by the port: one flax
    msgpack file a net, eddy_gan_64's scalers, `model_args.json`."""
    path.mkdir(exist_ok=True)
    for fname, tree in nets.items():
        save_variables(tree, str(path / f"{fname}.msgpack"))
    for s in ("x_scale.json", "y_scale.json"):
        shutil.copy(f"{SCALERS}/{s}", path / s)
    save_model_args(name, folder=str(path), **args)
    return str(path)


def _andrew(n_in, seed, **kw):
    return seeded_variables(tnets.AndrewCNN(n_in, 2, **kw), seed)


@pytest.fixture(scope="module")
def forcing_ds():
    """Operator2 at 16^2 of two 32^2 DNS runs in float64, 3 snapshots each,
    on the (run, time, lev, y, x) dims the harness reads. 30 hours in, q is
    1e-7; the fields are scaled to a developed flow's 5e-6 (the forcing,
    quadratic, by the square), at which the closures' float32 is accurate
    to the bar: at 1e-7 the ANN's output is a cancellation of its biases,
    and both packages miss float64 by 4e-5 of max|ref|."""
    p = TParams(nx=32, dt=3600.0, tmax=30 * 3600.0, precision="double")
    runs = [r["Operator2-16-dealias"] for r in generate_subgrid_forcing_batch(
        [16], p, sampling_freq=10 * 3600.0, operators=("Operator2",),
        keys=[0, 1], device="cpu")]
    ds = txr.Dataset(attrs=dict(runs[0].attrs))
    for k in ("q_forcing_advection", "q", "u", "v", "psi"):
        scale = 50.0 ** (2 if k == "q_forcing_advection" else 1)
        ds[k] = txr.DataArray(np.stack([r[k].values for r in runs]) * scale,
                              ("run",) + runs[0][k].dims)
    return ds


# ------------------------------------------------------------ the copies

COPIES = {"qg/spectral.py": tspectral, "eval/metrics.py": tmetrics,
          "eval/forecast.py": tforecast}


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copies_are_verbatim(path):
    """Each copied numpy module is its twin's text after a docstring line
    that names the twin."""
    copy = inspect.getsource(COPIES[path])
    with open(os.path.join(ROOT, "pyqg_generative_tpu", path)) as f:
        twin = f.read()
    head = (f'"""Verbatim copy of `pyqg_generative_tpu/{path}` (numpy only), '
            "kept\nhere so that the PyTorch port never imports the JAX "
            'package.\n\n')
    assert copy == head + twin[3:]


def test_apply_in_batches_matches_twin():
    """Batches of 3 over 7 rows, two outputs, concatenated on the host."""
    x = np.arange(7 * 4, dtype=np.float32).reshape(7, 4)
    out = apply_in_batches(lambda a: (a * 2, a.sum(-1)), x, batch_size=3,
                           device="cpu")
    ref = jtrain.apply_in_batches(lambda a: (a * 2, a.sum(-1)), x,
                                  batch_size=3)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


# ------------------------------------------- offline predict, test_offline

def _ols(tmp_path):
    tree = _andrew(2, 70, hidden_channels=HID)
    twin = _scalers(jols.OLSModel(folder=MISSING, hidden_channels=HID))
    twin.variables = tree
    return _write_folder(tmp_path / "ols", "OLSModel", {"net": tree},
                         hidden_channels=list(HID)), twin


def _ann(tmp_path):
    folder = f"{MODELS}/ann_eddy_jet"
    twin = jann.ANNModel(folder=MISSING, read=False)
    with open(f"{folder}/net.msgpack", "rb") as f:
        twin.variables = serialization.msgpack_restore(f.read())
    with open(f"{folder}/scale.json") as f:
        scale = json.load(f)
    twin.x_scale, twin.y_scale = scale["x_scale"], scale["y_scale"]
    return folder, twin


def _gz(tmp_path):
    mean = _andrew(2, 71, hidden_channels=HID)
    var = seeded_variables(tnets.VarCNN(2, 2, hidden_channels=HID), 72)
    twin = _scalers(jgz.MeanVarModel(folder=MISSING, hidden_channels=HID))
    twin.vars_mean, twin.vars_var = mean, var
    return _write_folder(tmp_path / "gz", "MeanVarModel",
                         {"net_mean": mean, "net_var": var},
                         hidden_channels=list(HID)), twin


DETERMINISTIC = {"ols": _ols, "ann": _ann, "gz": _gz}


def _from_twin(ds):
    """A twin's Dataset in the port's xrlite."""
    out = txr.Dataset(attrs=dict(ds.attrs))
    for k in ds.keys():
        out[k] = txr.DataArray(ds[k].values, ds[k].dims, ds[k].coords)
    return out


def _same_harness(model, twin, ds, tds, preds):
    """test_offline of the port and of the twin, each handed the twin's
    predictions `preds`: every variable, its dims and the float32 cast, at
    rtol 1e-10 (the same numpy code on the same input)."""
    model.predict = lambda ds, M: _from_twin(preds)
    twin.predict = lambda ds, M: preds
    out = model.test_offline(ds, 4)
    ref = twin.test_offline(tds, 4)
    assert sorted(out.keys()) == sorted(ref.keys())
    assert len(ref.keys()) == 53
    for k in ref.keys():
        assert out[k].dims == ref[k].dims, k
        assert out[k].values.dtype == ref[k].values.dtype == np.float32, k
        _exact(out[k].values, ref[k].values)


@pytest.mark.parametrize("case", sorted(DETERMINISTIC) + ["physical"])
def test_offline_matches_twin(case, forcing_ds, tmp_path):
    """The offline `predict` of OLS, the shipped ANN, GZ (its sample drawn
    from numpy's default_rng(0) in both) and ZannaBolton2020 (in the DNS's
    float64, read off the dataset's pyqg_params) against the twin's, each
    variable at the float32 bar (rtol 1e-10 for the physical closure); then
    `test_offline` on those predictions against the twin's harness."""
    if case == "physical":
        model, twin = ZannaBolton2020(device="cpu"), jphys.ZannaBolton2020()
    else:
        folder, twin = DETERMINISTIC[case](tmp_path)
        model = load_model(folder, device="cpu")
    tds = _to_twin(forcing_ds, tmp_path)
    pred, ref = model.predict(forcing_ds, 4), twin.predict(tds, 4)
    assert sorted(pred.keys()) == sorted(ref.keys())
    for k in ref.keys():
        assert pred[k].dims == ref[k].dims == ("run", "time", "lev", "y",
                                               "x"), k
        assert pred[k].values.dtype == ref[k].values.dtype, k
        (_exact if case == "physical" else _close)(pred[k].values,
                                                    ref[k].values)
    assert np.abs(ref["q_forcing_advection_mean"].values).max() > 0
    _same_harness(model, twin, forcing_ds, tds, ref)


def _gan(tmp_path, dtype="float32"):
    g, m = _andrew(4, 73, hidden_channels=HID), _andrew(2, 74)
    folder = _write_folder(tmp_path / "gan", "CGANRegression",
                           {"G": g, "net_mean": m}, regression="full_loss",
                           nx=16, generator="Andrew", div=False,
                           hidden_channels=list(HID))
    twin = _scalers(jgan.CGANRegression(folder=MISSING, hidden_channels=HID,
                                        regression="full_loss"))
    twin.vars_G, twin.vars_mean = g, m
    return load_model(folder, device="cpu", inference_dtype=dtype), twin


def _vae(tmp_path):
    d = _andrew(4, 75, hidden_channels=HID)
    folder = _write_folder(tmp_path / "vae", "CVAERegression",
                           {"decoder": d}, regression="None",
                           hidden_channels=list(HID))
    twin = _scalers(jvae.CVAERegression(folder=MISSING, hidden_channels=HID))
    twin.vars_dec = d
    return load_model(folder, device="cpu", online_variant="packed"), twin


def _bottleneck(tmp_path):
    trees = {"deep_decoder": seeded_variables(
        tnets.Upsampling(100, 4, 2, nx=32), 76), "decoder": _andrew(4, 77),
        "net_mean": _andrew(2, 78)}
    folder = _write_folder(tmp_path / "bottleneck", "CVAEBottleneck", trees,
                           regression="full_loss", nx=32, div=False,
                           decoder_var="adaptive", deep_latent=100)
    twin = _scalers(jbot.CVAEBottleneck(folder=MISSING, nx=32))
    twin.vars_deep, twin.vars_dec, twin.vars_mean = (
        trees["deep_decoder"], trees["decoder"], trees["net_mean"])
    return load_model(folder, device="cpu"), twin


STOCHASTIC = {"gan": (_gan, 16), "gan_bf16": (
    lambda t: _gan(t, "bfloat16"), 16), "vae_packed": (_vae, 16),
    "bottleneck": (_bottleneck, 32)}


def _twin_mean_var(twin, x, zs):
    """The twin's `_mean_var_program` (cgan_regression.py:364-398) with its
    threefry draws replaced by zs (M, B, ...): the same scan body through
    the twin's `_generate_with`, jitted."""
    M = zs.shape[0]

    def program(variables, x, zs):
        def body(carry, z):
            s, ss, first, is_first = carry
            y = twin._generate_with(variables, x, z)
            first = jnp.where(is_first, y, first)
            return (s + y, ss + y * y, first, jnp.zeros_like(is_first)), None

        zero = jnp.zeros_like(x[..., :2])
        (s, ss, first, _), _ = jax.lax.scan(
            body, (zero, zero, zero, jnp.ones((), bool)), zs)
        mean = s / M
        var = (ss - M * mean ** 2) / max(M - 1, 1)
        return first, mean, var

    return jax.jit(program)(twin._predict_variables(), jnp.asarray(x),
                            jnp.asarray(zs))


def _program_inputs(model, nx, seed, B=3, M=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nx, nx, 2)).astype(np.float32)
    zs = rng.standard_normal((M, B) + tuple(model.latent_shape(nx, nx))
                             ).astype(np.float32)
    return x, zs


@pytest.mark.parametrize("case", sorted(STOCHASTIC))
def test_mean_var_program_matches_twin(case, tmp_path):
    """The GAN (with a mean net; also at inference_dtype bfloat16, whose
    offline chain is a float32 pack of its own), the VAE with "packed" (K2's
    plain version) and the bottleneck: sample, mean and variance of M = 8
    injected draws, handed over in chunks of 3, 3 and 2, against the twin's
    program on the same draws. The variance is held at the float32 bar of
    the mean squared, the size of the rounding of the twin's formula."""
    make, nx = STOCHASTIC[case]
    model, twin = make(tmp_path)
    x, zs = _program_inputs(model, nx, 80)
    draws = [torch.from_numpy(zs[a:b]) for a, b in ((0, 3), (3, 6), (6, 8))]
    first, mean, var = model._mean_var_program(8)(torch.from_numpy(x),
                                                  draws)
    ref = _twin_mean_var(twin, x, zs)
    _close(first, ref[0])
    _close(mean, ref[1])
    # var = (ss - M mean^2) / (M - 1) cancels where mean^2 >> var, so its
    # rounding is of the size of mean^2's: the float32 bar on mean^2
    np.testing.assert_allclose(var.numpy(), ref[2], rtol=2e-4,
                               atol=2e-5 * float(np.max(ref[1] ** 2)))
    if case == "gan_bf16":
        assert model._offline_cnn().packed.dtype == torch.float32
        assert model._online_cnn().packed.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="draws"):
        model._mean_var_program(9)(torch.from_numpy(x), draws)


def test_predict_and_test_offline_of_a_gan(forcing_ds, tmp_path):
    """The GAN's `predict` gives the twin's keys, dims and shapes, and its
    mean and variance are the program's on the draws of a generator seeded
    with the key; `test_offline` on the twin's predictions from injected
    draws equals the twin's harness on them. A switch of weights drops the
    offline pack."""
    model, twin = _gan(tmp_path)
    pred = model.predict(forcing_ds, M=4, key=5)
    tds = _to_twin(forcing_ds, tmp_path)
    ref = twin.predict(tds, M=4, key=5)
    assert sorted(pred.keys()) == sorted(ref.keys())
    for k in ref.keys():
        assert pred[k].dims == ref[k].dims
        assert pred[k].shape == ref[k].shape == (2, 3, 2, 16, 16)
    X = model.x_scale.normalize(extract(forcing_ds, "q"))
    gen = torch.Generator().manual_seed(5)
    zs = torch.randn((4, 6, 16, 16, 2), generator=gen)
    first, mean, var = model._mean_var_program(4)(torch.from_numpy(X), [zs])
    _close(pred["q_forcing_advection_mean"].values,
           np.moveaxis(model.y_scale.denormalize(mean.numpy()), -1,
                       1).reshape(2, 3, 2, 16, 16))

    def predictions(package, first, mean, var, scale):
        ds = package.Dataset()
        for k, a in (("", scale.denormalize(np.asarray(first))),
                     ("_mean", scale.denormalize(np.asarray(mean))),
                     ("_var", scale.denormalize_var(np.asarray(var)))):
            ds["q_forcing_advection" + k] = package.DataArray(
                np.moveaxis(a, -1, 1).reshape(2, 3, 2, 16, 16),
                ("run", "time", "lev", "y", "x"))
        return ds

    _same_harness(model, twin, forcing_ds, tds, predictions(
        jxr, *_twin_mean_var(twin, X, zs.numpy()), twin.y_scale))
    packed = model._offline_cnn().packed
    shutil.copy(tmp_path / "gan" / "G.msgpack", tmp_path / "gan" /
                "G_opt.msgpack")
    assert model.use_optimal_epoch()
    assert model._offline_cache is None
    assert model._offline_cnn().packed is not packed


def test_predict_ensemble_keeps_snapshots_apart(forcing_ds, tmp_path):
    """A GAN whose latent weights are zero gives every member of a snapshot
    that snapshot's forcing: the port's ensemble does, for 2 x 3 snapshots
    and M = 2. The twin's reshape reads its (M, B) draws as (B, M), so its
    member 0 of snapshot 3 (run 1) is snapshot 0's forcing (ROADMAP, queue
    3)."""
    g = _andrew(4, 79, hidden_channels=HID)
    g["params"]["Conv_0"]["kernel"][:, :, 2:] = 0.0
    folder = _write_folder(tmp_path / "flat", "CGANRegression", {"G": g},
                           regression="None", nx=16, generator="Andrew",
                           div=False, hidden_channels=list(HID))
    ens = load_model(folder, device="cpu").predict_ensemble(forcing_ds, M=2)
    assert ens.dims == ("ens", "run", "time", "lev", "y", "x")
    assert ens.shape == (2, 2, 3, 2, 16, 16)
    a = ens.values
    _close(a[1], a[0])
    far = np.abs(a[0, 1, 0] - a[0, 0, 0]).max()
    twin = _scalers(jgan.CGANRegression(folder=MISSING, hidden_channels=HID))
    twin.vars_G = g
    ref = twin.predict_ensemble(_to_twin(forcing_ds, tmp_path), M=2).values
    # the twin's (snapshot n, member e) is its draw row n*M + e, read as
    # (member e', snapshot k) with e'*6 + k = n*M + e: snapshot 3 (run 1,
    # time 0), member 0 is snapshot 0's forcing
    _close(ref[0, 0, 0], a[0, 0, 0])
    assert np.abs(ref[0, 1, 0] - a[0, 0, 0]).max() < 1e-3 * far


# -------------------------------------------------------- the comparison

P = dict(nx=32, dt=14400.0, tmax=12 * 14400.0, tavestart=0.0,
         taveint=14400.0, precision="double")


def _in_double(ds):
    """The run's snapshots and spectra in float64, for both packages."""
    out = txr.Dataset(attrs=dict(ds.attrs))
    for k in ds.keys():
        da = ds[k]
        out[k] = txr.DataArray(da.values.astype(np.float64)
                               if da.values.dtype == np.float32
                               else da.values, da.dims, da.coords, da.attrs)
    return out


@pytest.fixture(scope="module")
def runs():
    """Two 12-step runs at 32^2 with diagnostics, 6 snapshots each."""
    return [_in_double(run_simulation(TParams(**P), sampling_freq=2 * 14400.0,
                                      key=k, device="cpu")) for k in (0, 7)]


@pytest.mark.parametrize("operator", ["Operator1", "Operator2",
                                      "Operator5"])
def test_coarsegrain_reference_matches_twin(runs, operator, tmp_path):
    """Snapshots coarse-grained to 16^2 on the port's operator (CPU) and
    the spectra truncated and filter-weighted, against the twin's, in
    float64."""
    out = tcmp.coarsegrain_reference_dataset(runs[0], 16, operator,
                                             device="cpu")
    ref = jcmp.coarsegrain_reference_dataset(_to_twin(runs[0], tmp_path),
                                             16, operator)
    assert sorted(out.keys()) == sorted(ref.keys())
    assert out["q"].shape == (6, 2, 16, 16)
    for k in ref.keys():
        assert out[k].dims == ref[k].dims
        _exact(out[k].values, ref[k].values)


def test_diagnostic_differences_match_twin(runs, tmp_path):
    """The normalised differences, the differences and the scales, and the
    distributional and spectral scores, between two runs."""
    out = tcmp.diagnostic_differences(runs[0], runs[1], T=4)
    ref = jcmp.diagnostic_differences(_to_twin(runs[0], tmp_path, "a"),
                                      _to_twin(runs[1], tmp_path, "b"), T=4)
    for o, r in zip(out, ref):
        assert sorted(o) == sorted(r)
        _exact([o[k] for k in sorted(r)], [r[k] for k in sorted(r)])
    assert tcmp.distrib_score(out[0]) > 0
    _exact(tcmp.distrib_score(out[0]), jcmp.distrib_score(ref[0]))
    _exact(tcmp.spectral_score(out[0]), jcmp.spectral_score(ref[0]))


@pytest.mark.parametrize("writer", ["port", "twin"])
def test_smart_read_uses_the_others_cache(runs, writer, tmp_path):
    """dataset_smart_read of one package writes the statistics cache beside
    the runs; the other's reads that cache (the same name and fingerprint),
    leaves it untouched, and gives the same statistics."""
    for i, ds in enumerate(runs):
        ds.to_npz(str(tmp_path / f"{i}.npz"))
    path = str(tmp_path / "*.npz")
    first, second = (tcmp, jcmp) if writer == "port" else (jcmp, tcmp)
    a = first.dataset_smart_read(path, compute_all=False)
    caches = glob.glob(str(tmp_path / "*.cache_npz.npz"))
    assert len(caches) == 1
    mtime = os.stat(caches[0]).st_mtime_ns
    b = second.dataset_smart_read(path, compute_all=False)
    assert os.stat(caches[0]).st_mtime_ns == mtime
    for k in ("PDF_q1", "PDF_KE2", "KEspecr", "KEfluxr", "Energysumr",
              "KE_time"):
        _exact(b[k].values, a[k].values)


def test_metrics_copy_matches_twin(forcing_ds, tmp_path):
    """The copied subgrid scores and PDF histogram on the forcing data."""
    S = forcing_ds["q_forcing_advection"]
    out = tmetrics.subgrid_scores(S, S * 0.5, S * 0.9)
    tS = _to_twin(forcing_ds, tmp_path)["q_forcing_advection"]
    ref = jmetrics.subgrid_scores(tS, tS * 0.5, tS * 0.9)
    assert sorted(out.keys()) == sorted(ref.keys())
    for k in ref.keys():
        _exact(out[k].values, ref[k].values)
    for o, r in zip(tmetrics.PDF_histogram(S.values.ravel() / 1e-11, -5, 5),
                    jmetrics.PDF_histogram(S.values.ravel() / 1e-11, -5, 5)):
        _exact(o, r)


# ------------------------------------------------------------- entry()

def _twin_entry_step(model_vars, dtype, eps, noise0, backend="xla"):
    """The twin's entry() step (`__graft_entry__.py:50-73`) on the given
    generator weights at `dtype`, the sampler handed noise0 and its one draw
    replaced by eps: (forcing, q after the step)."""
    m = jgan.CGANRegression(nx=64, folder=MISSING, inference_dtype=dtype,
                            online_backend=backend)
    m.vars_G = model_vars
    m.x_scale = ChannelwiseScaler.from_stats([0.0, 0.0], [1e-5, 1e-5])
    m.y_scale = ChannelwiseScaler.from_stats([0.0, 0.0], [1e-11, 1e-11])
    p = JParams(nx=64, dt=14400.0, precision="single")
    step = jsim.make_online_step(p, m, sampling="AR1", nsteps=1,
                                 with_diags=False)
    state = jcore.init_state(jcore.default_initial_q(
        p, rng=np.random.default_rng(0)), p)
    sstate = jsto.SamplerState(
        noise=jnp.asarray(noise0), forcing=jnp.zeros((2, 64, 64),
                                                     jnp.float32),
        counter=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
    real = jsto.jax
    jsto.jax = SimpleNamespace(lax=jax.lax, random=SimpleNamespace(
        split=jax.random.split,
        normal=lambda key, shape, dtype=jnp.float32: jnp.asarray(
            eps.reshape(shape), dtype)))
    try:
        state, sstate, _ = jax.jit(lambda a, b: step((a, b, None)))(
            state, sstate)
    finally:
        jsto.jax = real
    return np.asarray(sstate.forcing), np.asarray(jcore.fields(state.qh,
                                                               p).q)


@pytest.fixture(scope="module")
def entry_steps():
    """The port's entry() step in bf16 and, on the same weights and draws,
    in float32; the twin's entry step on the same weights and noise in
    float32 (xla) and in bf16 through its Pallas kernel (interpret mode)."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        fn, (state, sstate) = tentry.entry(device="cpu")
        model = tentry.untrained_gan(64, device="cpu") \
            if dtype == "float32" else None
        noise0 = sstate.noise.clone()
        if model is not None:
            model.compute_dtype = torch.float32
            step = make_online_step(TParams(nx=64, dt=14400.0,
                                            precision="single"), model,
                                    "AR1", 1, with_diags=False)
            state, sstate, _ = step((state, sstate, None))
        else:
            state, sstate = fn(state, sstate)
        q = tcore.fields(state.qh, TParams(nx=64, dt=14400.0,
                                           precision="single")).q
        out[dtype] = (sstate.forcing.numpy(), q.numpy(),
                      sstate.noise.numpy(), noise0.numpy())
    tree = tentry.untrained_gan(64, device="cpu").vars_G
    eps, noise0 = out["bfloat16"][2], out["bfloat16"][3]
    np.testing.assert_array_equal(out["float32"][2], eps)
    out["twin_f32"] = _twin_entry_step(tree, "float32", eps, noise0)
    out["twin_pallas_bf16"] = _twin_entry_step(tree, "bfloat16", eps, noise0,
                                               backend="pallas")
    return out


def _rel_rms(out, ref):
    return float(np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2)))


def test_entry_step_matches_twin_in_float32(entry_steps):
    """entry()'s model and draws with its generator in float32, against the
    twin's entry step in float32 on the same weights and noise: the forcing
    at the float32 bar, q after the step to 2e-5 of max|q|."""
    f, q, _, _ = entry_steps["float32"]
    f_ref, q_ref = entry_steps["twin_f32"]
    _close(f, f_ref)
    np.testing.assert_allclose(q, q_ref, rtol=0,
                               atol=2e-5 * np.abs(q_ref).max())


def test_entry_step_in_bf16(entry_steps):
    """entry() itself, in bf16 (Conv_0 in float32, the chain through K1's
    wrapper on bf16 inputs): relative RMS < 2% from the twin's float32 step
    (the bf16 bar of tests/test_pallas_conv.py:65-76), and from the twin's
    own bf16 step through the Pallas kernel K1-bf16 replaces less than a
    quarter of that kernel's distance from float32: at the entry's initial
    condition flipped bf16 roundings grow through the chain (ROADMAP, queue
    3), so two correct bf16 chains that sum in different orders do not agree
    to the 1e-3 of tests/test_torch_variants.py:67-89."""
    f, q, _, _ = entry_steps["bfloat16"]
    f32, _ = entry_steps["twin_f32"]
    pallas, q_pallas = entry_steps["twin_pallas_bf16"]
    assert _rel_rms(f, f32) < 2e-2
    assert _rel_rms(f, pallas) < 0.25 * _rel_rms(pallas, f32)
    assert np.isfinite(q).all()
    assert np.abs(q - q_pallas).max() < 1e-3 * np.abs(q_pallas).max()
