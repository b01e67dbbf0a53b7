"""The port's parallel package on the CPU: the sweep and the tp placements
against the twin's, and the multi-rank checks from one run of
`dryrun_multichip(4, device="cpu")` (dp 2 x tp 2; "ens" and "dp" over all
4), each check a test of its own. Its ranks run `rank_checks_with_twins`:
the dry run's own checks, then those of the twin's `tests/test_parallel.py`
(which runs them on its 8-device virtual mesh). The ranks are child
processes under the spawn's hard timeout; they import no jax."""
import contextlib
import io
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyqg_generative_torch.entry import dryrun_multichip
from pyqg_generative_torch.ml.nets import AndrewCNN
from pyqg_generative_torch.ml.train import make_train_step, named_params
from pyqg_generative_torch.ml.weights import params_from_jax, \
    seeded_variables
from pyqg_generative_torch.models.common import mse_loss_fn
from pyqg_generative_torch.parallel import dryrun, product_configs, \
    run_experiment, shard_params_tp, spawn
from pyqg_generative_torch.parallel.mesh import DataParallel, Replicate, \
    Shard, batch_sharding, ensemble_sharding, make_mesh, sync_batchnorm, \
    tensor_parallel
from pyqg_generative_torch.parallel.spawn import run_ranks
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.sim.simulate import run_ensemble
from pyqg_generative_torch.utils import xrlite as xr

torch.set_num_threads(1)

RANKS = 4
TIMEOUT = 120.0  # seconds for the spawn; about 15 s on 8 CPUs
DRYRUN = "pyqg_generative_torch.parallel.dryrun:rank_checks"
# the twin's bars (tests/test_parallel.py): float64 ensemble; float32 loss,
# parameters (rtol, atol) and outputs (rtol, atol)
ENS64_RTOL, ENS64_ATOL = 1e-10, 1e-14
DP_LOSS_RTOL, DP_RTOL, DP_ATOL = 1e-6, 1e-5, 1e-7
TP_RTOL, TP_ATOL, TP_GRAD_BAR = 1e-5, 1e-6, 1e-5


def _close(a, b, rtol, atol) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where allclose holds."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def ensemble_float64(ens_mesh, n: int, device) -> dict:
    p = QGParams(nx=16, dt=14400.0, tmax=10 * 14400.0, tavestart=0.0,
                 precision="double")
    kw = dict(n_ens=2 * n, sampling_freq=5 * 14400.0, with_diags=False,
              key=3, device=device)
    q = run_ensemble(p, sharding=ensemble_sharding(ens_mesh), **kw)
    q_ref = run_ensemble(p, **kw)
    a, b = (torch.as_tensor(d["q"].values) for d in (q, q_ref))
    err = _close(a, b, ENS64_RTOL, ENS64_ATOL)
    return {"members": 2 * n, "err": err, "ok": err <= 1.0}


class _SGD:
    """optax.sgd(lr): p - lr g, no state."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    @torch.no_grad()
    def step(self, params, grads, state):
        for p, g in zip(params.values(), grads):
            p.sub_(self.lr * g)


def _seeded_cnn(hidden, batch_norm, device, seed=0):
    net = AndrewCNN(2, 2, hidden_channels=hidden, batch_norm=batch_norm)
    net.load_state_dict(params_from_jax(seeded_variables(net, seed)))
    return net.to(device)


def dp_step(dp_mesh, device, batch_norm: bool) -> dict:
    """One SGD(0.1) step of the MSE of an AndrewCNN (hidden 8) on Y = X / 2,
    the batch over "dp", against one rank's step on the whole batch."""
    n = dist.get_world_size(dp_mesh.get_group("dp"))
    gen = torch.Generator(device=device).manual_seed(0)
    X = torch.randn((4 * n, 8, 8, 2), generator=gen, device=device)
    Y = 0.5 * X
    ref = _seeded_cnn((8,), batch_norm, device)
    loss_ref = make_train_step(mse_loss_fn(ref), ref, _SGD(0.1))(
        {}, (X, Y))["loss"]
    net = _seeded_cnn((8,), batch_norm, device)
    if batch_norm:
        sync_batchnorm(net, dp_mesh, "dp")
    lo, hi = batch_sharding(dp_mesh, "dp").rows(len(X))
    loss = make_train_step(mse_loss_fn(net), net, DataParallel(
        _SGD(0.1), dp_mesh, "dp"))({}, (X[lo:hi], Y[lo:hi]))["loss"]
    loss = loss.clone()
    dist.all_reduce(loss, group=dp_mesh.get_group("dp"))
    loss = loss / n
    out = {"loss_err": float((loss - loss_ref).abs() / loss_ref.abs()),
           "param_err": max(_close(v, ref.state_dict()[k], DP_RTOL, DP_ATOL)
                            for k, v in net.state_dict().items()
                            if not k.endswith("num_batches_tracked"))}
    out["ok"] = out["loss_err"] <= DP_LOSS_RTOL and out["param_err"] <= 1.0
    return out


def tp_conv(mesh, device) -> dict:
    """An AndrewCNN (hidden 16, 16) with its output channels over "tp" and
    the batch over "dp" against the replicated net: outputs, and the
    gradients of their sum of squares."""
    dp = dist.get_world_size(mesh.get_group("dp"))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((2 * dp, 16, 16, 2), generator=gen, device=device)
    lo, hi = batch_sharding(mesh, "dp").rows(len(x))
    ref = _seeded_cnn((16, 16), False, device).eval()
    y_ref = ref(x[lo:hi])
    g_ref = dict(zip(named_params(ref), torch.autograd.grad(
        (y_ref ** 2).sum(), list(ref.parameters()))))
    net = tensor_parallel(_seeded_cnn((16, 16), False, device).eval(), mesh)
    y = net(x[lo:hi])
    g = dict(zip(named_params(net), torch.autograd.grad(
        (y ** 2).sum(), list(net.parameters()))))
    out = {"err": _close(y, y_ref, TP_RTOL, TP_ATOL),
           "grad_err": dryrun._max_rel(g, g_ref, dryrun._tp_rows(mesh)),
           "split": sorted(k for k, v in g.items()
                           if v.shape != g_ref[k].shape)}
    out["ok"] = out["err"] <= 1.0 and out["grad_err"] <= TP_GRAD_BAR
    return out


def rank_checks_with_twins(n_devices: int, device_type: str) -> dict:
    """What a rank of the dry run runs (`dryrun.rank_checks`), then the
    twin's checks above on this rank; raises naming those that fail."""
    out = dryrun.rank_checks(n_devices, device_type)
    device = torch.device(device_type)
    mesh = make_mesh({"dp": out["dp"], "tp": out["tp"]})
    dp_mesh = make_mesh({"dp": n_devices})
    out.update(
        ensemble_float64=ensemble_float64(make_mesh({"ens": n_devices}),
                                          n_devices, device),
        dp_step=dp_step(dp_mesh, device, False),
        dp_step_bn=dp_step(dp_mesh, device, True),
        tp_conv=tp_conv(mesh, device))
    failed = {k: v for k, v in out.items()
              if isinstance(v, dict) and not v["ok"]}
    if failed:
        raise AssertionError(f"rank {dist.get_rank()}: {failed}")
    return out


@pytest.fixture(scope="module")
def readings():
    """Every rank's readings of `dryrun_multichip(4, device="cpu")`, its
    ranks running `rank_checks_with_twins` in its stead, and what it
    printed."""
    run = spawn.run_ranks

    def with_twins(target, *args, **kw):
        assert target == DRYRUN
        return run(f"{Path(__file__).stem}:rank_checks_with_twins",
                   *args, **kw)

    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spawn, "run_ranks", with_twins)
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [str(Path(__file__).parent)]
            + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
               if p]))
        with contextlib.redirect_stdout(printed):
            result = dryrun_multichip(RANKS, device="cpu", timeout=TIMEOUT)
    return result, printed.getvalue()


def test_dryrun_multichip_cpu(readings):
    readings, printed = readings
    assert printed == (f"dryrun_multichip OK on {RANKS} devices "
                       f"(dp=2, tp=2, ens={RANKS})\n")
    assert len(readings) == RANKS
    for r in readings:
        assert (r["dp"], r["tp"], r["ens"]) == (2, 2, RANKS)


def test_children_import_no_jax(readings):
    readings, _ = readings
    assert all(r["imported_jax"] == [] for r in readings)


def test_sharded_ensemble_matches_unsharded(readings):
    """No closure, float64, 8 members over 4 ranks: rtol 1e-10 (twin
    :20-30), on every rank."""
    for r in readings[0]:
        c = r["ensemble_float64"]
        assert c["members"] == 2 * RANKS and c["err"] <= 1.0 and c["ok"]


def test_sharded_gan_ensemble_member_for_member(readings):
    """The untrained 16^2 GAN in float32, AR1, diagnostics on, one member a
    rank: each member within ENS_BAR of max|q| of the unsharded run (a
    rank's convolutions see 1 member where the unsharded run's see 4)."""
    for r in readings[0]:
        c = r["ensemble_gan"]
        assert c["finite"] and c["err"] <= dryrun.ENS_BAR and c["ok"]


def test_dp_step_matches_single_rank(readings):
    """SGD step, no BatchNorm, the batch of 16 over 4 ranks: loss rtol
    1e-6, parameters rtol 1e-5 / atol 1e-7 (twin :33-67)."""
    for r in readings[0]:
        c = r["dp_step"]
        assert c["loss_err"] <= DP_LOSS_RTOL and c["param_err"] <= 1


def test_dp_step_with_sync_batchnorm_matches_single_rank(readings):
    """The same with BatchNorm, its statistics all-reduced over "dp":
    parameters and running statistics at the same bars."""
    for r in readings[0]:
        c = r["dp_step_bn"]
        assert c["loss_err"] <= DP_LOSS_RTOL and c["param_err"] <= 1


def test_tp_conv_matches_replicated(readings):
    """AndrewCNN (16, 16) with its output channels over tp = 2: outputs at
    rtol 1e-5 / atol 1e-6 (twin :81-102), parameter gradients to 1e-5 of
    each tensor's largest; every conv weight is split."""
    for r in readings[0]:
        c = r["tp_conv"]
        assert c["err"] <= 1.0 and c["grad_err"] <= TP_GRAD_BAR
        assert c["split"] == ["Conv_0.weight", "Conv_1.weight",
                              "Conv_2.weight"]


def test_dp_tp_gan_step_matches_single_rank(readings):
    """The full GAN batch step (critic with its gradient penalty, then the
    generator), batch 8 over dp = 2, conv channels over tp = 2, float64:
    every bar of `parallel.dryrun`, on every rank."""
    for r in readings[0]:
        c = r["gan_step"]
        assert c["ok"] and c["kink_units"] == 0
        assert c["grad_err"] <= dryrun.GRAD_BAR
        assert c["param_err"] <= dryrun.PARAM_BAR
        assert c["stats_err"] <= dryrun.STATS_BAR


def test_dp_tp_gan_step_float32_matches_single_rank(readings):
    """The same step in float32, on the first seed whose generator ReLUs
    and critic LeakyReLUs all keep their sign between the sharded and the
    single-rank step (seed 0 on this mesh, on an x86 CPU): gradients to
    5e-5 of each tensor's largest, losses and BatchNorm statistics to 1e-5,
    parameters to 2 lr (`parallel.dryrun`), on every rank."""
    for r in readings[0]:
        c = r["gan_step_f32"]
        assert c["ok"] and c["dtype"] == "float32" and c["kink_units"] == 0
        assert c["seed"] < dryrun.F32_SEEDS
        assert c["grad_err"] <= dryrun.GRAD32_BAR
        assert max(c["loss_err"], c["g_loss_err"]) <= dryrun.LOSS32_BAR
        assert c["stats_err"] <= dryrun.STATS32_BAR
        assert c["param_err"] <= dryrun.PARAM32_BAR


def test_spawn_raises_on_a_failing_rank():
    """Both ranks fail to import their target: the parent raises at the
    first exit, without waiting out its limit."""
    with pytest.raises(RuntimeError, match="of 2 exited with code 1"):
        run_ranks("pyqg_generative_torch.nowhere:f", 2, "cpu", 60.0)


def test_spawn_raises_on_a_timeout():
    """Ranks that never return (signal.pause) are killed at the limit."""
    with pytest.raises(RuntimeError, match="still running after 1.5 s"):
        run_ranks("signal:pause", 2, "cpu", 1.5)


def test_dryrun_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        dryrun_multichip(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(1)


def test_shard_params_tp_specs_are_twins():
    """The twin's tree (:70-78) on a dp 4 x tp 2 mesh, in the port's layout
    (out, in, kh, kw): its P(None, None, None, "tp") is the port's
    Shard(0) of the output channels, its P() Replicate()."""
    from jax.sharding import PartitionSpec as P

    from pyqg_generative_tpu.parallel import make_mesh as jmake_mesh
    from pyqg_generative_tpu.parallel import shard_params_tp as jshard
    twin_tree = {"conv": {"kernel": np.zeros((3, 3, 4, 8)),
                          "bias": np.zeros((8,))},
                 "odd": {"kernel": np.zeros((3, 3, 4, 7))}}
    twin = jshard(twin_tree, jmake_mesh({"dp": 4, "tp": 2}))
    port_tree = {"conv": {"weight": torch.zeros(8, 4, 3, 3),
                          "bias": torch.zeros(8)},
                 "odd": {"weight": torch.zeros(7, 4, 3, 3)}}
    mesh = types.SimpleNamespace(shape=(4, 2), mesh_dim_names=("dp", "tp"))
    port = shard_params_tp(port_tree, mesh)
    for layer, kernel in (("conv", "weight"), ("odd", "weight"),
                          ("conv", "bias")):
        jkey = "kernel" if kernel == "weight" else "bias"
        split = twin[layer][jkey].spec == P(None, None, None, "tp")
        assert port[layer][kernel].placement == (
            Shard(0) if split else Replicate())
        assert port[layer][kernel].axis == ("tp" if split else None)
    assert twin["conv"]["kernel"].spec == P(None, None, None, "tp")
    assert port["conv"]["weight"].placement == Shard(0)


def test_product_configs_are_twins():
    from pyqg_generative_tpu.parallel import product_configs as jproduct
    axes = dict(nx=[8, 16], seed=[0, 1], op=["a"])
    assert product_configs(**axes) == jproduct(**axes)


def test_sweep_runner(tmp_path):
    """The twin's test (:119-135) on the port's copy."""
    cfgs = product_configs(nx=[8, 16], seed=[0])
    assert len(cfgs) == 2

    calls = []

    def fn(nx, seed):
        calls.append((nx, seed))
        ds = xr.Dataset()
        ds["x"] = xr.DataArray(np.zeros((nx,)), ("x",))
        return ds

    res = run_experiment(str(tmp_path), fn, cfgs, verbose=False)
    assert len(res) == 2
    # re-run skips existing outputs
    run_experiment(str(tmp_path), fn, cfgs, verbose=False)
    assert len(calls) == 2
    back = xr.Dataset.from_npz(res["8-0"])
    assert back["x"].values.shape == (8,)
