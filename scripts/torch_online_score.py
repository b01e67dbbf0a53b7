"""Rerun the paper's round-5 online scores at 96^2 with the PyTorch port on
one CUDA card, from the committed weights.

The port's counterpart of scripts/r3_online_score.py (which imports jax),
for the cells of scripts/r5_stages.json stage `gan96_op1_online` as
r3_online_score.py:62-101 ran them:
- each closure online at 96^2, eddy, dt from `with_nx` (7200 s), 20 years,
  `tavestart` 5 years, single precision, 10 members through
  `run_ensemble_segmented` in 24 segments, sampling "constant" with
  nsteps 1, snapshots every ANDREW_1000_STEPS; members start from
  `set_initial_condition(p, 1000 * key + j)`, key 0;
- the GAN and the VAE on their `opt` epoch, GZ on its final one, and the
  run without a closure; a cell "name:key" runs its members from that key
  (`none:1`, whose distance from `none` is the online runs' spread);
- each scored by `exp.pipeline.compute_online_metrics` with Operator1 at
  96^2 against the eddy 256^2 reference: 10 members x 20 years, `tavestart`
  5 years, single precision, member j0 + j starting from
  `set_initial_condition(p, 1000 * j0 + j)` for j0 = 0, 2, 4, 6, 8 and j =
  0, 1, as scripts/campaign_r2_data.py:44-56 ran it in chunks of 2 with
  key j0 (here the 10 members advance together from those states);
  --ref-seed-offset shifts those seeds, for another realization of the
  reference, whose distance from the first is the reference's spread.

Outputs go to --out (build/online_scores/, git-ignored): the reference's
members, each cell's members under <cell>/online/ and its
metrics_<reference>.json.
The reference is reused where its 10 files are there. Each cell prints one
JSON line: both scores, the committed target, the seconds of the run and
of the scoring, member-steps/s, K1's launches and the card's name and
power limit (nvidia-smi). With --developed, after the GAN's cell the
card's step is held against the CPU's on its last snapshot: 2 members, 10
steps of frozen noise, the GAN in float32 to 2e-5 of max|q|, and GZ in
bf16 by `fused_conv.layer_check` on the chain's real input at steps 0 and
10 (every layer against float64 at relative RMS <= LAYER_BAR, the chain
equal to its layers composed), GZ in float32 to 2e-5 of max|q|.

Run from the repository root (the default is every cell, the committed
runs; --years, --members, --nx and --ref-nx only shrink a rehearsal):
    python3 scripts/torch_online_score.py --cell gan vae gz none none:1 \
        --developed
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MODELS = ROOT / "trained_models"
TARGETS = ROOT / "data_r2" / "eddy" / "lores_96"
# cell -> (model folder or None, epoch, the committed metrics file)
CELLS = {
    "gan": (MODELS / "r4_eddy_gan_96_op1_s0", "opt",
            MODELS / "r4_eddy_gan_96_op1_s0" /
            "metrics_eddy-constant-0-opt.json"),
    "vae": (MODELS / "r4_eddy_vae_96_op1_s0", "opt",
            MODELS / "r4_eddy_vae_96_op1_s0" /
            "metrics_eddy-constant-0-opt.json"),
    "gz": (MODELS / "r4_eddy_gz_96_op1_s0", "final",
           MODELS / "r4_eddy_gz_96_op1_s0" / "metrics_eddy-constant-0.json"),
    "none": (None, None, TARGETS / "metrics_eddy-none-0-op1.json"),
}
OPERATOR = "Operator1"
SEGMENTS = 24  # run_ensemble_segmented's, as the committed cells ran
CPU = torch.device("cpu")
F32_BOUND = 2e-5  # |card - CPU| / max|q| after 10 frozen-noise steps


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def params(args, nx):
    from pyqg_generative_torch.exp.pipeline import CONFIGURATIONS
    from pyqg_generative_torch.qg.params import YEAR
    return CONFIGURATIONS["eddy"].with_nx(nx).replace(
        tmax=args.years * YEAR, tavestart=args.tavestart_years * YEAR,
        precision="single")


def reference(args, out: pathlib.Path) -> tuple:
    """The 256^2 reference's folder, run unless its members are there, and
    the readings of its run (None where reused)."""
    from pyqg_generative_torch.qg.params import ANDREW_1000_STEPS
    from pyqg_generative_torch.sim import run_ensemble_segmented, \
        set_initial_condition
    offset = args.ref_seed_offset
    folder = out / (f"reference_{args.ref_nx}" if offset == 0 else
                    f"reference_{args.ref_nx}_seed{offset}")
    n = args.members
    if all((folder / f"{j}.npz").exists() for j in range(n)):
        return folder, None
    p = params(args, args.ref_nx)
    q0 = torch.stack([set_initial_condition(p, 1000 * j0 + j + offset)
                      for j0 in range(0, n, 2) for j in range(min(2, n - j0))])
    t0 = time.perf_counter()
    ds = run_ensemble_segmented(p, None, n_ens=n, q_init=q0,
                                sampling_freq=ANDREW_1000_STEPS,
                                n_segments=SEGMENTS, device=args.device)
    sync(args.device)
    seconds = time.perf_counter() - t0
    folder.mkdir(parents=True, exist_ok=True)
    for j in range(n):
        ds.isel(run=j).to_npz(str(folder / f"{j}.npz"))
    steps = ds["q"].sizes()["time"] * round(ANDREW_1000_STEPS / p.dt)
    return folder, {"seconds": seconds, "members": n, "steps": steps,
                    "member_steps_per_s": n * steps / seconds}


def load(folder, epoch, device, **overrides):
    from pyqg_generative_torch.models import load_model
    model = load_model(str(folder), device=device, **overrides)
    if epoch == "opt" and not model.use_optimal_epoch():
        raise FileNotFoundError(f"no opt weights in {folder}")
    return model


def cell_key(spec: str) -> tuple:
    """"name" or "name:key" -> (name, key); key 0 is the committed run."""
    name, _, key = spec.partition(":")
    if name not in CELLS:
        raise ValueError(f"unknown cell {name!r}; cells are {list(CELLS)}")
    return name, int(key or 0)


def run_cell(spec, args, out, ref_folder, smi):
    """One cell's online run and score; returns (its JSON row, its
    Dataset)."""
    from pyqg_generative_torch.exp.pipeline import compute_online_metrics
    from pyqg_generative_torch.ml import fused_conv
    from pyqg_generative_torch.qg.params import ANDREW_1000_STEPS
    from pyqg_generative_torch.sim import run_ensemble_segmented
    name, key = cell_key(spec)
    folder, epoch, target_file = CELLS[name]
    p = params(args, args.nx)
    param = None if folder is None else {
        "self": load(folder, epoch, args.device), "sampling": "constant",
        "nsteps": 1}
    launches = fused_conv.launches
    t0 = time.perf_counter()
    ds = run_ensemble_segmented(p, param, n_ens=args.members,
                                sampling_freq=ANDREW_1000_STEPS, key=key,
                                n_segments=SEGMENTS, device=args.device)
    sync(args.device)
    seconds = time.perf_counter() - t0
    launches = fused_conv.launches - launches
    cell = out / (name if key == 0 else f"{name}_key{key}")
    (cell / "online").mkdir(parents=True, exist_ok=True)
    for j in range(args.members):
        ds.isel(run=j).to_npz(str(cell / "online" / f"{j}.npz"))
    t0 = time.perf_counter()
    norm = compute_online_metrics(str(out), str(cell),
                                  str(ref_folder / "*.npz"), OPERATOR,
                                  args.nx,
                                  save_file=f"metrics_{ref_folder.name}.json",
                                  device=args.device)
    score_seconds = time.perf_counter() - t0
    with open(target_file) as f:
        target = json.load(f)
    steps = ds["q"].sizes()["time"] * round(ANDREW_1000_STEPS / p.dt)
    row = {"cell": name, "reference": ref_folder.name,
           "distrib_score": norm["distrib_score"],
           "spectral_score": norm["spectral_score"],
           "target": {k: target[k] for k in ("distrib_score",
                                             "spectral_score")},
           "target_file": str(target_file.relative_to(ROOT)),
           "epoch": epoch, "key": key, "members": args.members,
           "steps": steps, "seconds": seconds,
           "member_steps_per_s": args.members * steps / seconds,
           "score_seconds": score_seconds, "k1_launches": launches,
           "card": smi}
    return row, ds


def frozen_steps(model, p, q0, noise, device, steps=10):
    """q after `steps` steps of frozen noise from q0 (2, lev, ny, nx)."""
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    step = make_online_step(p, model, "AR1", -1, with_diags=False)
    carry = init_run_carry(p, q0, 0, model, with_diags=False, device=device)
    carry[1].noise = torch.as_tensor(noise, device=device).reshape(
        carry[1].noise.shape)
    for _ in range(steps):
        carry = step(carry)
    return core.fields(carry[0].qh, p).q.cpu().numpy()


def held(what, out, ref):
    scale = float(np.abs(ref).max())
    diff = float(np.abs(out - ref).max()) / scale
    log(f"developed flow, {what}: max|card - CPU| / max|q| {diff:.3e} "
        f"(max|q| {scale:.3e}, bar {F32_BOUND:.0e})")
    if not diff <= F32_BOUND:
        raise AssertionError(f"developed flow, {what}: {diff:.3e}")
    return diff


def developed_flow(args, q_end):
    """The checks on the GAN's last snapshot (see the module's
    docstring)."""
    from pyqg_generative_torch.ml import fused_conv
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    p = params(args, args.nx)
    q0 = np.ascontiguousarray(q_end[:2], dtype=np.float32)
    out = {"max_abs_q": float(np.abs(q0).max())}
    gan, _, _ = CELLS["gan"]
    gz, _, _ = CELLS["gz"]
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((2, args.nx, args.nx, 2)).astype(np.float32)
    out["gan_f32"] = held("GAN, float32", frozen_steps(
        load(gan, "opt", args.device), p, q0, noise, args.device),
        frozen_steps(load(gan, "opt", CPU), p, q0, noise, CPU))
    f32 = dict(inference_dtype="float32")
    out["gz_f32"] = held("GZ, float32", frozen_steps(
        load(gz, "final", args.device, **f32), p, q0, noise, args.device),
        frozen_steps(load(gz, "final", CPU, **f32), p, q0, noise, CPU))
    # GZ in bf16 (path 2's settings): each layer of its chain on the
    # chain's real input, at steps 0 and 10
    model = load(gz, "final", args.device, inference_dtype="bfloat16",
                 online_variant="dxbpair")
    packed = model._online_fns()[0].packed
    step = make_online_step(p, model, "AR1", -1, with_diags=False)
    carry = init_run_carry(p, q0, 0, model, with_diags=False,
                           device=args.device)
    carry[1].noise = torch.as_tensor(noise, device=args.device).reshape(
        carry[1].noise.shape)
    kernel = fused_conv.fused_cnn_forward
    checks = {}
    for at in range(11):
        if at in (0, 10):
            seen = []

            def spy(x, pk):
                seen.append(x.clone())
                return kernel(x, pk)
            fused_conv.fused_cnn_forward = spy
            try:
                step(carry)
            finally:
                fused_conv.fused_cnn_forward = kernel
            rep = fused_conv.layer_check(seen[0], packed, kernel)
            worst = max(rel for rel, _, _ in rep["layers"])
            log(f"developed flow, GZ bf16, step {at}: the chain's layers "
                f"against float64, relative RMS up to {worst:.3e} (bar "
                f"{fused_conv.LAYER_BAR:.0e}); composed equal "
                f"{rep['composed_equal']}")
            if not (worst <= fused_conv.LAYER_BAR and rep["composed_equal"]):
                raise AssertionError(f"developed flow, GZ bf16 at step {at}:"
                                     f" {rep}")
            checks[f"step{at}"] = {
                "layers_rel_rms": [rel for rel, _, _ in rep["layers"]],
                "composed_equal": rep["composed_equal"]}
        carry = step(carry)
    out["gz_bf16_layer_check"] = checks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", nargs="+",
                    default=["gan", "vae", "gz", "none", "none:1"],
                    help="cells, each 'name' or 'name:key' (members from "
                         "set_initial_condition(p, 1000 * key + j)); names: "
                         + ", ".join(CELLS))
    ap.add_argument("--ref-seed-offset", type=int, default=0,
                    help="another reference realization: its member seeds "
                         "shifted by this (0 is the committed reference)")
    ap.add_argument("--out", default=str(ROOT / "build" / "online_scores"))
    ap.add_argument("--developed", action="store_true",
                    help="after the GAN's cell, hold the card's step "
                         "against the CPU's on its last snapshot")
    ap.add_argument("--years", type=float, default=20.0)
    ap.add_argument("--tavestart-years", type=float, default=5.0)
    ap.add_argument("--members", type=int, default=10)
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ref-nx", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        log("torch_online_score: CUDA is not available")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_name() if args.device is None else str(args.device)
    from pyqg_generative_torch.device import resolve_device
    args.device = resolve_device(args.device)
    for spec in args.cell:
        cell_key(spec)
    out = pathlib.Path(args.out)
    ref_folder, ref = reference(args, out)
    if ref is not None:
        log(f"the {args.ref_nx}^2 reference: {ref} on {smi}")
        print(json.dumps({"cell": ref_folder.name, **ref, "card": smi}),
              flush=True)
    for spec in args.cell:
        row, ds = run_cell(spec, args, out, ref_folder, smi)
        log(f"{spec}: distrib {row['distrib_score']:.4f} (target "
            f"{row['target']['distrib_score']:.4f}), spectral "
            f"{row['spectral_score']:.4f} (target "
            f"{row['target']['spectral_score']:.4f}), "
            f"{row['member_steps_per_s']:.1f} member-steps/s on {smi}")
        print(json.dumps(row), flush=True)
        if spec == "gan" and args.developed:
            dev = developed_flow(args, ds["q"].values[:, -1])
            print(json.dumps({"developed_flow": dev, "card": smi}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
