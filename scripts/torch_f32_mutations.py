"""Mutation check of the float32 kernels K1 and K2 (one FMA tile body,
csrc/conv_fma.cuh) on one NVIDIA GPU: each mutant is a copy of
pyqg_generative_torch, made in a temporary directory outside the repository,
with one deliberate fault in a kernel's source, built there and checked on
the main path's chain (eddy_gan_64, K1) and path 3's (the VAE decoder of
r4_eddy_vae_64_op1_s0, K2) at 10 x 64^2, each on Conv_0's output of a random
field. Three checks a kernel:
- "gate": the chain against its plain version at rtol 2e-4 / atol
  2e-5*max|ref|, the bar the kernels have been held to since they were
  ported;
- "part1": fused_conv.layer_check's per-layer part, every layer against
  float64 at relative RMS <= LAYER_BAR (3e-5);
- "part2": its composition part, the chain equal to its layers composed,
  bitwise.
The unmutated copy must pass all three for both kernels; each mutant must
fail the part named in MUTANTS for each kernel it touches.

Run from the repository root on a machine with the card and nvcc:
python3 scripts/torch_f32_mutations.py
It prints one JSON line per copy and exits nonzero if any copy misbehaves.
"""
import json
import os
import sys

from torch_k1_bf16_mutations import ROOT, run_mutants

BODY = "csrc/conv_fma.cuh"
CHAIN = "csrc/packed_chain.cu"
TAP = "((ky * T::K + kx) * T::CC + c) * T::COB)"
SWAPPED = ("(((ky * T::K + kx) < 2 ? 1 - (ky * T::K + kx) : ky * T::K + kx)"
           " * T::CC + c) * T::COB)")

# name -> (file, text, replacement, {kernel: the part that must fail}),
# None: intact
MUTANTS = {
    "none": None,
    # Conv_1 (the one 5x5 layer) writes its output times 1 + 1e-4
    "scale_conv1_1e-4": (
        BODY, "const float r = acc[p][q] + bias[co];",
        "float r = acc[p][q] + bias[co];\n"
        "        if constexpr (T::K == 5) r *= 1.0f + 1e-4f;",
        {"K1": "part1", "K2": "part1"}),
    # the last input channel of every staged chunk reads as zero
    "drop_last_channel_of_chunk": (
        BODY, "const bool ok = c0 + c < cin;",
        "const bool ok = c0 + c < cin && c != T::CC - 1;",
        {"K1": "part1", "K2": "part1"}),
    "swap_taps_0_and_1": (BODY, TAP, SWAPPED,
                          {"K1": "part1", "K2": "part1"}),
    # K2's persistent loop reads each layer's weights at the offset of the
    # layer before
    "k2_weight_offset_one_layer_early": (
        CHAIN, "const Tc* w = wflat + chain.woff[i];",
        "const Tc* w = wflat + chain.woff[i > 0 ? i - 1 : 0];",
        {"K2": "part2"}),
}


def check(package_dir):
    """The three checks of K1 and K2 with the package copy in
    `package_dir`; one JSON line."""
    sys.path.insert(0, package_dir)
    import torch
    from pyqg_generative_torch.ml import fused_conv as fc
    from pyqg_generative_torch.ml.nets import fold_batchnorm
    from pyqg_generative_torch.ml.weights import read_msgpack
    assert fc.__file__.startswith(package_dir), fc.__file__
    torch.backends.cudnn.allow_tf32 = False
    models = os.path.join(ROOT, "trained_models")
    out = {}
    for name, path, forward, plain_fn in (
            ("K1", f"{models}/eddy_gan_64/G.msgpack", fc.fused_cnn_forward,
             fc.fused_cnn_forward_plain),
            ("K2", f"{models}/r4_eddy_vae_64_op1_s0/decoder.msgpack",
             fc.packed_cnn_forward, fc.packed_cnn_forward_plain)):
        apply = fc.make_online_cnn(fold_batchnorm(read_msgpack(path)),
                                   device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(21)
        x = apply.first_layer(torch.randn((10, 64, 64, 4), generator=gen,
                                          device="cuda"))
        packed = apply.packed
        chain = forward(x, packed)
        plain = plain_fn(x, packed)
        rep = fc.layer_check(x, packed, forward)
        rels = [rel for rel, _, _ in rep["layers"]]
        out[name] = {
            "gate": bool(torch.allclose(chain, plain, rtol=2e-4, atol=2e-5 *
                                        float(plain.abs().max()))),
            "part1": max(rels) <= fc.LAYER_BAR,
            "part2": rep["composed_equal"],
            "layer_rel_rms": rels,
            "chain_max_abs_err_vs_plain": float((chain - plain).abs().max())}
    return out


def main():
    def caught(name, res):
        if MUTANTS[name] is None:
            return all(res[k][part] for k in ("K1", "K2")
                       for part in ("gate", "part1", "part2"))
        return all(not res[k][part] for k, part in MUTANTS[name][3].items())

    return 1 if run_mutants(MUTANTS, __file__, caught) else 0


if __name__ == "__main__":
    if len(sys.argv) == 2:
        print(json.dumps(check(sys.argv[1])))
        sys.exit(0)
    sys.exit(main())
