"""The experiment CLI: python -m pyqg_generative_torch.exp.cli <subcommand>.

Twin of `pyqg_generative_tpu/exp/cli.py`, with its six subcommands, flags
and output layout (JSON configurations and the class registry, no `eval()`
of user strings):

  reference      an unparameterized run or ensemble -> npz a member
  forcing        a DNS and its subgrid-forcing datasets -> npz a combination
  parameterized  a closure's online run or ensemble -> npz a member
  forecast       an ensemble forecast from a stored initial condition
  train          a closure fitted on forcing datasets, with the paper's run
                 splits (reference tools/train_model.py:36-55)
  metrics        online differences against a target dataset -> json

It differs from the twin in three ways:
- `--device` (default: the card; `cpu` only when asked) takes the place of
  the twin's compilation cache, which has no counterpart here;
- there is no `--online-backend`: the port's closure CNN always runs in its
  kernel (ROADMAP: the `online_backend` switch needs no counterpart);
- `--model-weight` scales the forcing of every closure, the physical ones
  too: the twin's `_weighted` wraps `predict_snapshot`, which the physical
  closures' online hook never calls, so they run unweighted (ROADMAP,
  queue 3).
"""
from __future__ import annotations

import argparse
import json
import os

from ..models import MODEL_REGISTRY, load_model
from ..qg.params import ANDREW_1000_STEPS, DAY, EDDY_PARAMS, JET_PARAMS, \
    QGParams
from ..sim import generate_subgrid_forcing, run_ensemble, run_simulation
from ..utils import xrlite as xr
from .pipeline import coarsen

PRESETS = {"eddy": EDDY_PARAMS, "jet": JET_PARAMS}


def params_from_args(args) -> QGParams:
    p = PRESETS[args.preset]
    if args.nx:
        p = p.with_nx(args.nx)
    if args.params:
        p = p.replace(**json.loads(args.params))
    return p


def add_device(sp):
    sp.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")


def add_common(sp):
    sp.add_argument("--preset", default="eddy", choices=list(PRESETS))
    sp.add_argument("--nx", type=int, default=0)
    sp.add_argument("--params", type=str, default="",
                    help="JSON dict of QGParams overrides")
    sp.add_argument("--sampling-freq", type=float, default=ANDREW_1000_STEPS)
    sp.add_argument("--subfolder", type=str, default=".")
    sp.add_argument("--ensemble-member", type=int, default=0)
    sp.add_argument("--n-ens", type=int, default=1)
    sp.add_argument("--key", type=int, default=0)
    add_device(sp)


def _write_members(args, p, parameterization=None):
    """An ensemble (one file a member) or one member's run, into
    args.subfolder."""
    os.makedirs(args.subfolder, exist_ok=True)
    if args.n_ens > 1:
        ds = run_ensemble(p, parameterization, n_ens=args.n_ens,
                          sampling_freq=args.sampling_freq, key=args.key,
                          device=args.device)
        for j in range(args.n_ens):
            ds.isel(run=j).to_npz(os.path.join(args.subfolder, f"{j}.npz"))
    else:
        run_simulation(p, parameterization,
                       sampling_freq=args.sampling_freq,
                       key=args.key + args.ensemble_member,
                       device=args.device).to_npz(
            os.path.join(args.subfolder, f"{args.ensemble_member}.npz"))


def cmd_reference(args):
    _write_members(args, params_from_args(args))


def cmd_forcing(args):
    p = params_from_args(args)
    Nc = json.loads(args.nc) if args.nc else [32, 48, 64, 96, 128]
    out = generate_subgrid_forcing(Nc, p, args.sampling_freq,
                                   key=args.key + args.ensemble_member,
                                   device=args.device)
    for name, ds in out.items():
        os.makedirs(os.path.join(args.subfolder, name), exist_ok=True)
        ds.to_npz(os.path.join(args.subfolder, name,
                               f"{args.ensemble_member}.npz"))


def cmd_parameterized(args):
    p = params_from_args(args)
    if args.closure:
        # a folderless closure by registry name (the reference's
        # `--parameterization ClassName`, tools/simulate.py:206-244,
        # without eval())
        kw = json.loads(args.closure_args) if args.closure_args else {}
        model = MODEL_REGISTRY[args.closure](device=args.device, **kw)
    else:
        model = load_model(args.model_folder, device=args.device)
    if args.model_weight != 1.0:
        model = Weighted(model, args.model_weight)
    _write_members(args, p, {"self": model, "sampling": args.sampling,
                             "nsteps": args.nsteps})


class Weighted:
    """A closure whose forcing is `w` times `model`'s (reference
    `model_weight`, tools/simulate.py:242), offline and in the online
    step's hooks, which reach the physical closures too (the twin's
    `_weighted`, :105-112, scales `predict_snapshot` alone); every other
    attribute is the model's."""

    def __init__(self, model, w: float):
        self.model, self.w = model, w

    def __getattr__(self, name):
        return getattr(self.model, name)

    def predict_snapshot(self, q, noise=None):
        return self.w * self.model.predict_snapshot(q, noise)

    def predict_mean_snapshot(self, q, M=100):
        return self.w * self.model.predict_mean_snapshot(q, M)

    def online_forcing(self, flds, noise, p):
        return self.w * self.model.online_forcing(flds, noise, p)

    def online_mean_forcing(self, flds, p):
        return self.w * self.model.online_mean_forcing(flds, p)


def cmd_forecast(args):
    """An ensemble forecast from one stored IC: member 0, the ensemble's
    mean and std (reference tools/simulate.py:254-293)."""
    p = params_from_args(args)
    ic = xr.Dataset.from_npz(args.initial_condition)
    q_init = ic["q"].isel(time=args.ic_time).values
    if "run" in ic["q"].dims:
        q_init = q_init[args.ic_run]
    if args.operator and q_init.shape[-1] != p.nx:
        # coarse-grain a high-resolution IC with the training operator
        # (reference tools/simulate.py:268-271)
        q_init = coarsen(q_init, args.operator, p.nx, args.device)
    model = load_model(args.model_folder, device=args.device) \
        if args.model_folder else None
    parameterization = None if model is None else \
        {"self": model, "sampling": args.sampling, "nsteps": args.nsteps}
    ds = run_ensemble(p, parameterization, n_ens=args.n_ens, q_init=q_init,
                      sampling_freq=1 * DAY, key=args.key,
                      with_diags=False, device=args.device)
    out = xr.Dataset(attrs=ds.attrs)
    for var in ("q", "u", "v", "psi"):
        out[var] = ds[var].isel(run=0)
        out[var + "_mean"] = ds[var].mean("run")
        out[var + "_std"] = ds[var].std("run")
    os.makedirs(args.subfolder, exist_ok=True)
    out.to_npz(os.path.join(args.subfolder, f"{args.number}.npz"))


def cmd_train(args):
    """Fit a closure with the paper's run splits (reference
    tools/train_model.py:36-55), and score it offline."""
    ds = xr.open_mfdataset(args.train_path, "run")
    nrun = ds["q"].sizes()["run"]
    tr = json.loads(args.splits) if args.splits else \
        [0, int(0.833 * nrun), int(0.917 * nrun), nrun]
    ds_train = ds.isel(run=slice(tr[0], tr[1]))
    ds_validate = ds.isel(run=slice(tr[1], tr[2]))
    ds_test = ds.isel(run=slice(tr[2], tr[3]))

    model_args = json.loads(args.model_args) if args.model_args else {}
    model_args["folder"] = args.model_folder
    model = MODEL_REGISTRY[args.model](device=args.device, **model_args)
    fit_kw = json.loads(args.fit_args) if args.fit_args else {}
    model.fit(ds_train, ds_validate, **fit_kw)
    model.test_offline(ds_test, ensemble_size=args.ensemble_size).to_npz(
        os.path.join(args.model_folder, "offline_test.npz"))
    if args.transfer_path:
        ds_tr = xr.open_mfdataset(args.transfer_path, "run")
        model.test_offline(ds_tr, ensemble_size=args.ensemble_size).to_npz(
            os.path.join(args.model_folder, "offline_transfer.npz"))


def cmd_metrics(args):
    """Online similarity metrics (reference comparison_tools.py:412-438),
    on the host."""
    from ..eval.comparison import diagnostic_differences
    model = xr.open_mfdataset(args.model_path, "run")
    target = xr.Dataset.from_npz(args.target_path)
    difference, _, _ = diagnostic_differences(model, target, T=args.T)
    difference["key"] = args.key_name
    with open(args.save_file, "w") as f:
        json.dump(difference, f)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pyqg-generative-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("reference")
    add_common(s)
    s.set_defaults(fn=cmd_reference)

    s = sub.add_parser("forcing")
    add_common(s)
    s.add_argument("--nc", type=str, default="")
    s.set_defaults(fn=cmd_forcing)

    s = sub.add_parser("parameterized")
    add_common(s)
    s.add_argument("--model-folder", type=str, default="model")
    s.add_argument("--closure", type=str, default="",
                   help="registry class name for a folderless closure "
                        "(e.g. Laplace, ZannaBolton2020, ADM)")
    s.add_argument("--closure-args", type=str, default="",
                   help="JSON ctor kwargs for --closure")
    s.add_argument("--sampling", type=str, default="AR1")
    s.add_argument("--nsteps", type=int, default=1)
    s.add_argument("--model-weight", type=float, default=1.0)
    s.set_defaults(fn=cmd_parameterized)

    s = sub.add_parser("forecast")
    add_common(s)
    s.add_argument("--model-folder", type=str, default="")
    s.add_argument("--sampling", type=str, default="AR1")
    s.add_argument("--nsteps", type=int, default=1)
    s.add_argument("--initial-condition", type=str, required=True)
    s.add_argument("--ic-time", type=int, default=-1)
    s.add_argument("--ic-run", type=int, default=0)
    s.add_argument("--number", type=int, default=0)
    s.add_argument("--operator", type=str, default="",
                   help="coarse-grain a high-res IC with this operator")
    s.set_defaults(fn=cmd_forecast)

    s = sub.add_parser("train")
    s.add_argument("--model", type=str, required=True,
                   choices=sorted(MODEL_REGISTRY))
    s.add_argument("--model-args", type=str, default="")
    s.add_argument("--fit-args", type=str, default="")
    s.add_argument("--model-folder", type=str, default="model")
    s.add_argument("--train-path", type=str, required=True)
    s.add_argument("--transfer-path", type=str, default="")
    s.add_argument("--splits", type=str, default="")
    s.add_argument("--ensemble-size", type=int, default=1000)
    add_device(s)
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("metrics")
    s.add_argument("--model-path", type=str, required=True)
    s.add_argument("--target-path", type=str, required=True)
    s.add_argument("--save-file", type=str, required=True)
    s.add_argument("--key-name", type=str, default="")
    s.add_argument("--T", type=int, default=128)
    s.set_defaults(fn=cmd_metrics)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
