"""Mutation check of K1-bf16's two-part check (fused_conv.layer_check) on one
NVIDIA GPU: each mutant is a copy of pyqg_generative_torch, made in a
temporary directory outside the repository, with one deliberate fault in the
kernel's source, built there and checked on the merged GZ pair
(r4_eddy_gz_64_op1_s0) at 10 x 64^2. Part 1 holds each layer against float64
at relative RMS <= LAYER_BAR; part 2 holds the chain equal to its layers
composed. Each mutant must fail one part; the unmutated copy must pass both.
The old chain-level bar (relative RMS <= 1e-3 against the plain version) is
printed beside them.

Run from the repository root on a machine with the card and nvcc:
python3 scripts/torch_k1_bf16_mutations.py
It prints one JSON line per copy and exits nonzero if any copy misbehaves.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "csrc/conv_mma_bf16.cuh"
EPILOGUE = ("            float v = acc[r][4 * j + 2 * i + e] + "
            "bias[g * cout_g + n];\n")


def _scale(eps):
    """Conv_1 (the one 5x5 layer) writes its output times 1 + eps."""
    return (HEADER, EPILOGUE,
            EPILOGUE + f"            if constexpr (K == 5) v *= 1.0f + {eps}f;\n")


# name -> (file, text, replacement, the part that must fail), None: intact
MUTANTS = {
    "none": None,
    "scale_1e-4": (*_scale("1e-4"), 1),
    "scale_1e-3": (*_scale("1e-3"), 1),
    "scale_1e-2": (*_scale("1e-2"), 1),
    "drop_last_8_input_channels": (
        HEADER, "const int valid = min(8, cin_g - ch);",
        "const int valid = min(8, cin_g - 8 - ch);", 1),
    "swap_taps_0_and_1": (
        HEADER, "make_desc(b0 + tap * N * KC * 2,",
        "make_desc(b0 + (tap == 0 ? 1 : tap == 1 ? 0 : tap) * N * KC * 2,", 1),
    # the chain starts each next layer's weights one group's block early
    "wrong_group_offset": (
        "csrc/fused_conv.cu",
        "woff += pqg_tc::packed_weight_elems(K, cin, cout, groups);",
        "woff += pqg_tc::packed_weight_elems(K, cin, cout, groups) / groups;",
        2),
}


def check(package_dir):
    """Parts 1 and 2 with the package copy in `package_dir`; one JSON
    line."""
    sys.path.insert(0, package_dir)
    import torch
    from pyqg_generative_torch.ml import fused_conv as fc
    from pyqg_generative_torch.ml.nets import fold_batchnorm
    from pyqg_generative_torch.ml.weights import read_msgpack
    assert fc.__file__.startswith(package_dir), fc.__file__
    gz = os.path.join(ROOT, "trained_models", "r4_eddy_gz_64_op1_s0")
    pair = fc.merge_folded_pair(*(
        fold_batchnorm(read_msgpack(f"{gz}/{n}.msgpack"))
        for n in ("net_mean", "net_var")))
    apply = fc.make_online_cnn(pair, torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_in = pair["params"]["Conv_0"]["kernel"].shape[2]
    x = apply.first_layer(torch.randn((10, 64, 64, n_in), generator=gen,
                                      device="cuda"))
    rep = fc.layer_check(x, apply.packed)
    chain = fc.fused_cnn_forward(x, apply.packed)
    plain = fc.fused_cnn_forward_plain(x, apply.packed)
    old = float(((chain - plain) ** 2).mean().sqrt()
                / (plain ** 2).mean().sqrt())
    rels = [rel for rel, _, _ in rep["layers"]]
    return {"layer_rel_rms": rels,
            "part1_pass": max(rels) <= fc.LAYER_BAR,
            "part2_pass": rep["composed_equal"],
            "chain_rel_rms_vs_plain": old,
            "old_bar_1e-3_pass": old <= 1e-3}


def main():
    tmp = tempfile.mkdtemp()
    procs = {}
    try:
        for name, mutant in MUTANTS.items():
            copy = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, "pyqg_generative_torch"),
                            os.path.join(copy, "pyqg_generative_torch"),
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            if mutant:
                path = os.path.join(copy, "pyqg_generative_torch",
                                    mutant[0])
                with open(path) as f:
                    src = f.read()
                if src.count(mutant[1]) != 1:
                    raise RuntimeError(f"{name}: the text to mutate is not "
                                       "found once")
                with open(path, "w") as f:
                    f.write(src.replace(mutant[1], mutant[2]))
            # one process a copy, all at once: their nvcc builds overlap
            procs[name] = subprocess.Popen(
                [sys.executable, __file__, copy], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        bad = []
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                print(out[-3000:], file=sys.stderr)
                bad.append(name)
                continue
            res = json.loads(out.strip().splitlines()[-1])
            must_fail = MUTANTS[name][3] if MUTANTS[name] else None
            caught = must_fail is None and res["part1_pass"] and \
                res["part2_pass"] or must_fail is not None and \
                not res[f"part{must_fail}_pass"]
            print(json.dumps({"mutant": name, "as_expected": caught, **res}),
                  flush=True)
            if not caught:
                bad.append(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 2:
        print(json.dumps(check(sys.argv[1])))
        sys.exit(0)
    sys.exit(main())
