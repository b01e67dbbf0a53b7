"""Why the sharded float32 GAN step can miss the single-rank step: units at
their kink, measured.

`parallel.dryrun.gan_step` in float32 (the untrained 16^2 GAN's full batch
step, the batch of 4 dp over "dp" and the conv channels over "tp", against
one rank's step on the whole batch) on 1 to --ranks gloo ranks of the CPU,
for seeds 0 to --seeds - 1. For each run it prints the units whose
pre-activation (a ReLU of the generator, a LeakyReLU of the critic) has
another sign in the sharded step than in the single-rank one, by net, the
smallest |pre-activation| among them to its call's largest, and the step's
errors against their float32 bars: those with no such unit should pass
every bar, those with one miss the gradient's. One JSON line last.

    python3 scripts/torch_gan_step_kinks.py [--ranks 4] [--seeds 6]
"""
import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KEYS = ("loss_err", "g_loss_err", "grad_err", "stats_err", "param_err")


def rank_scan(n_devices: int, seeds: list) -> dict:
    """On each rank: gan_step in float32 for every seed."""
    import torch

    from pyqg_generative_torch.parallel import dryrun, make_mesh
    dp, tp = dryrun.dp_tp_split(n_devices)
    mesh = make_mesh({"dp": dp, "tp": tp})
    return {str(s): dryrun.gan_step(mesh, torch.device("cpu"),
                                    torch.float32, s) for s in seeds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    from pyqg_generative_torch.parallel import dryrun
    from pyqg_generative_torch.parallel.spawn import run_ranks
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(pathlib.Path(__file__).parent)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])
    seeds = list(range(args.seeds))
    rows = []
    for n in range(1, args.ranks + 1):
        dp, tp = dryrun.dp_tp_split(n)
        ranks = run_ranks(f"{pathlib.Path(__file__).stem}:rank_scan", n,
                          "cpu", 600.0, {"n_devices": n, "seeds": seeds})
        for s in map(str, seeds):
            r = ranks[0][s]
            row = {"ranks": n, "dp": dp, "tp": tp, "seed": int(s),
                   "kink_units": r["kink_units_by_net"],
                   "kink_margin": r["kink_margin"],
                   **{k: max(x[s][k] for x in ranks) for k in KEYS},
                   "ok": all(x[s]["ok"] for x in ranks)}
            rows.append(row)
            near = "" if row["kink_margin"] is None else \
                f" (the nearest at {row['kink_margin']:.2e} of its call's " \
                "largest)"
            print(f"{n} rank(s) (dp {dp}, tp {tp}), seed {s}: units at a "
                  f"kink G {row['kink_units']['G']}, D "
                  f"{row['kink_units']['D']}{near}; "
                  + ", ".join(f"{k} {row[k]:.2e}" for k in KEYS)
                  + f"; within the float32 bars: {row['ok']}", flush=True)
    clean = [r for r in rows if not sum(r["kink_units"].values())]
    kinked = [r for r in rows if sum(r["kink_units"].values())]
    summary = {"runs": len(rows), "without_kinks": len(clean),
               "without_kinks_all_ok": all(r["ok"] for r in clean),
               "with_kinks_any_ok": any(r["ok"] for r in kinked),
               "worst_without_kinks": {k: max((r[k] for r in clean),
                                              default=None) for k in KEYS},
               "grad_err_with_kinks": [min((r["grad_err"] for r in kinked),
                                           default=None),
                                       max((r["grad_err"] for r in kinked),
                                           default=None)],
               "rows": rows}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
