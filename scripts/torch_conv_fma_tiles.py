"""Tile-shape sweep of the float32 FMA tile body (csrc/conv_fma.cuh) on one
NVIDIA GPU: each variant is a copy of the package's csrc in a temporary
directory outside the repository with one text substitution (a tile shape
Tile<K, Q, GC, TY, CC>, or K2's per-SM share of items turned off), built
with nvcc and bound in place of the package's own library. For each variant
it times K1 (eddy_gan_64's chain) or K2 (the VAE decoder's) at 10 x 64^2,
by CUDA events over a chain call and by torch.profiler per layer (as
chip_smoke.f32_layer_ms reads them), checks the chain bitwise against the
unmodified kernel, and prints the ptxas line of each kernel it built.

Run from the repository root on a machine with the card and nvcc:
python3 scripts/torch_conv_fma_tiles.py
It prints one JSON line a variant.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pyqg_generative_torch.ml import _build, fused_conv as fc  # noqa: E402
from pyqg_generative_torch.ml.nets import fold_batchnorm  # noqa: E402
from pyqg_generative_torch.ml.weights import read_msgpack  # noqa: E402

K5 = "using K5Wide = Tile<5, 8, 4, 4, 4>;"
K3 = "using K3Wide = Tile<3, 8, 4, 4, 8>;"
K3H = "using K3Half = Tile<3, 4, 4, 4, 8>;"
BODY = "conv_fma.cuh"
# name -> (library, file in csrc, text, replacement); the first of each
# library is the package's own source
VARIANTS = {
    "k1 as built": ("fused_conv", BODY, K5, K5),
    "k1 5x5 Q=8 CC=8": ("fused_conv", BODY, K5, K5.replace("4>", "8>")),
    "k1 5x5 Q=16 CC=4": ("fused_conv", BODY, K5,
                         K5.replace("5, 8,", "5, 16,")),
    "k1 3x3 Q=4 CC=8": ("fused_conv", BODY, K3, K3.replace("3, 8,", "3, 4,")),
    "k1 3x3 Q=8 CC=16": ("fused_conv", BODY, K3, K3.replace("8>", "16>")),
    "k2 as built": ("packed_chain", BODY, K5, K5),
    # K2's wide 3x3 items at K1's width, 32 output channels
    "k2 3x3 Q=8": ("packed_chain", BODY, K3H, K3H.replace("3, 4,", "3, 8,")),
    "k2 no per-SM share": ("packed_chain", "packed_chain.cu",
                           "int balanced = blocks == resident;",
                           "int balanced = 0;"),
}


def variant_source(name, csrc=_build.CSRC):
    """(file, its text in variant `name`) from the sources in `csrc`;
    raises if the text to replace is not found exactly once."""
    _, fn, old, new = VARIANTS[name]
    with open(os.path.join(csrc, fn)) as f:
        text = f.read()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the text to replace is not found once "
                           f"in {fn}")
    return fn, text.replace(old, new)


def build(tmp):
    """Build every variant's library, all at once; returns {name: (path,
    ptxas lines of its kernels)}."""
    jobs = {}
    for i, (name, (lib, *_)) in enumerate(VARIANTS.items()):
        src = os.path.join(tmp, f"csrc{i}")
        shutil.copytree(_build.CSRC, src)
        fn, text = variant_source(name)
        with open(os.path.join(src, fn), "w") as f:
            f.write(text)
        out = os.path.join(tmp, f"lib{i}.so")
        jobs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", out,
             os.path.join(src, f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        ptxas = [m.strip() for j, line in enumerate(lines)
                 if "Compiling entry" in line and (
                     "conv_fma_kernel" in line
                     or "packed_chain_kernelIf" in line)
                 for m in lines[j + 1:j + 4] if "registers" in m]
        ptxas.append("spills: " + str(any(
            re.search(r"[1-9][0-9]* bytes spill", m) for m in lines)))
        built[name] = (out, ptxas)
    return built


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    chains = {}
    for key, path in (("k1", f"{cs.FOLDER}/G.msgpack"),
                      ("k2", f"{cs.PATHS['vae'][0]}/decoder.msgpack")):
        chains[key] = cs.chain_input(fc, fold_batchnorm(read_msgpack(path)),
                                     cs.MEMBERS, cs.NX, 31)
    refs = {"k1": fc.fused_cnn_forward(*chains["k1"][::-1]),
            "k2": fc.packed_cnn_forward(*chains["k2"][::-1])}
    tmp = tempfile.mkdtemp()
    real = fc._chain_function
    try:
        for name, (path, ptxas) in build(tmp).items():
            key = name[:2]
            lib = ctypes.CDLL(path)
            fn = getattr(lib, {"k1": "k1_fused_cnn_forward_f32",
                               "k2": "k2_packed_cnn_forward_f32"}[key])
            fn.restype = ctypes.c_int
            fn.argtypes = fc._K2_ARGS if key == "k2" else fc._CHAIN_ARGS
            fc._chain_function = lambda library, dtype, _fn=fn: _fn
            packed, x = chains[key]
            forward = {"k1": fc.fused_cnn_forward,
                       "k2": fc.packed_cnn_forward}[key]
            same = torch.equal(forward(x, packed), refs[key])
            ms = cs.cuda_ms(lambda: forward(x, packed))
            try:
                layers = cs.f32_layer_ms(fc, key.upper(), packed, x)
            except AssertionError as e:  # a reading the profiler missed
                layers = f"not measured: {e}"
            print(json.dumps({"variant": name, "card": smi, "chain_ms": ms,
                              "layer_ms": layers, "equal_to_built": same,
                              "ptxas": ptxas}), flush=True)
            fc._chain_function = real
    finally:
        fc._chain_function = real
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
