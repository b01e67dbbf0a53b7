"""Headline benchmark of the PyTorch port: online closure-ensemble throughput.

The port's counterpart of `bench.py`, with its flags and defaults: N members
at nx^2, dt = 14400 s, AR1 white noise, diagnostics on, driven through
`load_model` and `run_ensemble`, whose steady steps replay a captured CUDA
graph on the card. The first run is an untimed warm-up (the kernels' build,
cuFFT's plans, the graphs' capture); the timed run ends in a device-to-host
read of its snapshots.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, the rate
in member-steps/s against the reference stack's rate (BASELINE.md: pyqg on
the CPU plus torch, Colab online-simulations cells 12-14), and notes on
standard error: the device, with the card's name and power limit, and the
closure's FLOPs against the H100's peak for the kernel's arithmetic.

    python3 bench_torch.py           # eddy_gan_64, K1 in float32
    python3 bench_torch.py --infer-dtype bfloat16 --variant dxbpair \\
        --model-folder trained_models/r4_eddy_gz_64_op1_s0   # K1-bf16
    python3 bench_torch.py --variant packed \\
        --model-folder trained_models/r4_eddy_vae_64_op1_s0  # K2
    python3 bench_torch.py --cpu --nx 16 --members 2 --steps 4 --snap-every 2
"""
import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
# member-steps/s of the reference stack (BASELINE.md; bench.py:16-19)
BASELINE_MEMBER_STEPS_PER_S = 200.0
FAMILY_BASELINES = {"gan": 200.0, "vae": 203.0, "gz": 116.0}
FAMILIES = {"CGANRegression": "gan", "CVAERegression": "vae",
            "MeanVarModel": "gz"}
# one H100 SXM (NVIDIA data sheet, 700 W): float32 outside the tensor cores
# (K1 and K2 in float32), dense bf16 on the tensor cores (K1-bf16)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def _conv_flops(tree, nx: int) -> float:
    """2*K*K*cin*cout*nx^2 summed over the 4-D kernels of a weight tree
    (every layer of the AndrewCNN keeps nx^2), plus 2*n*m a dense layer."""
    if isinstance(tree, dict):
        return sum(_conv_flops(v, nx) for v in tree.values())
    shape = np.shape(tree)
    if len(shape) == 4:
        kh, kw, cin, cout = shape
        return 2.0 * kh * kw * cin * cout * nx * nx
    if len(shape) == 2:
        return 2.0 * shape[0] * shape[1]
    return 0.0


def model_flops_per_member_step(model, nx: int) -> tuple[float, str]:
    """FLOPs of the closure's nets in one member-step (the solver's FFTs
    excluded)."""
    nets = [(name, getattr(model, attr)["params"]) for name, attr in (
        ("G", "vars_G"), ("decoder", "vars_dec"), ("mean", "vars_mean"),
        ("var", "vars_var")) if getattr(model, attr, None) is not None]
    return (sum(_conv_flops(tree, nx) for _, tree in nets),
            "+".join(name for name, _ in nets))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--members", type=int, default=10)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--snap-every", type=int, default=250)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, each kernel's plain version")
    ap.add_argument("--model-folder",
                    default=str(ROOT / "trained_models" / "eddy_gan_64"))
    ap.add_argument("--infer-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute dtype of the closure's Conv_1..Conv_n "
                         "kernel (float32 sums either way)")
    ap.add_argument("--variant", default="dx",
                    help="online variant: 'dx', 'tap', 'dxf', 'dxb' (K1), "
                         "'packed' (K2), or a GZ pair such as 'dxbpair'")
    args = ap.parse_args(argv)

    import torch

    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg.params import QGParams
    from pyqg_generative_torch.sim import run_ensemble

    if not os.path.exists(os.path.join(args.model_folder,
                                       "model_args.json")):
        raise FileNotFoundError(f"no saved model in {args.model_folder}")
    device = "cpu" if args.cpu else None  # None: CUDA, or raise
    model = load_model(args.model_folder, device=device,
                       inference_dtype=args.infer_dtype,
                       online_variant=args.variant)
    family = FAMILIES.get(type(model).__name__, type(model).__name__.lower())

    n_snaps = max(1, args.steps // args.snap_every)
    total_steps = n_snaps * args.snap_every
    p = QGParams(nx=args.nx, dt=14400.0, tavestart=0.0, precision="single",
                 tmax=total_steps * 14400.0)
    closure = {"self": model, "sampling": "AR1", "nsteps": 1}

    def run_once():
        ds = run_ensemble(p, closure, n_ens=args.members,
                          sampling_freq=args.snap_every * p.dt,
                          device=device)
        # the snapshots are on the host: a real device-to-host read
        return float(np.sum(ds["q"].values[:, -1]))

    run_once()  # the build, cuFFT's plans, the graphs' capture
    t0 = time.perf_counter()
    checksum = run_once()
    wall = time.perf_counter() - t0
    if not math.isfinite(checksum):
        raise FloatingPointError("the timed run's snapshots are not finite")

    rate = args.members * total_steps / wall
    print(json.dumps({
        "metric": f"{family}_online_member_steps_per_s_{args.nx}sq_"
                  f"{args.members}member",
        "value": round(rate, 1),
        "unit": "member-steps/s",
        "vs_baseline": round(rate / FAMILY_BASELINES.get(
            family, BASELINE_MEMBER_STEPS_PER_S), 2)}))

    if args.cpu:
        where = "the CPU (each kernel's plain version)"
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        where = (f"{smi}, graphed steps; torch {torch.__version__}, "
                 f"CUDA {torch.version.cuda}")
    print(f"# wall {wall:.3f} s for {args.members} members x {total_steps} "
          f"steps at {args.nx}^2 on {where}; model {args.model_folder} "
          f"[{args.variant} {args.infer_dtype}]", file=sys.stderr)
    nn_flops, nets = model_flops_per_member_step(model, args.nx)
    sustained = nn_flops * rate
    note = f"# closure nets ({nets}): {nn_flops / 1e9:.3f} GFLOP a " \
        f"member-step, sustained {sustained / 1e12:.3f} TFLOP/s"
    if not args.cpu:
        peak = PEAK_FLOPS[args.infer_dtype]
        note += (f" = {100 * sustained / peak:.1f}% of the H100's "
                 f"{peak / 1e12:.0f} TFLOP/s {args.infer_dtype} peak "
                 "(dense nets counted; the solver's FFTs excluded)")
    print(note, file=sys.stderr)


if __name__ == "__main__":
    main()
