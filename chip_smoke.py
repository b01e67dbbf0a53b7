"""Smoke run of the PyTorch port (pyqg_generative_torch) on one NVIDIA GPU.

It drives the port's three online paths through `load_model` and
`run_ensemble`, each at 10 members x 64^2, dt = 14400 s, AR1 white noise,
diagnostics on:
- the main path: the GAN closure eddy_gan_64 in float32 (kernel K1);
- path 2: the GZ closure r4_eddy_gz_64_op1_s0 at bf16, variant "dxbpair"
  (the mean and variance nets merged into one 256/128/64-channel net; the
  probe K3 resolves "dxb", then K1-bf16 on the tensor cores, 2 groups a
  layer);
- path 3: the VAE closure r4_eddy_vae_64_op1_s0, variant "packed" (the
  decoder through K2, the whole ensemble in one launch, NHWC).

Phases, in order; any failure raises and the exit code is nonzero:
1. report the card (name and power limit from nvidia-smi), torch and CUDA;
2. build the kernels' three libraries (csrc/fused_conv.cu: K1 in float32
   and bf16; csrc/packed_chain.cu: K2; csrc/bitcast_probe.cu: K3), one nvcc
   each, all started together, and time the build;
3. hold each kernel against its plain PyTorch version at its path's shapes
   and on random weights at 3 x 48^2, and time the kernel, the plain version
   and a library yardstick (a chain of cuDNN convolutions; for K1-bf16 also
   cuDNN with groups=2 on the merged pair; for K3, one torch.stack of the
   row pairs viewed as int32, held against K3's words too), beside the
   kernel's bound:
   - K1 and K2, float32 (one FMA tile body, csrc/conv_fma.cuh):
     rtol 2e-4 / atol 2e-5*max|ref| against the plain version (float32 sums
     in another order; K2 also at 2 x 32 x 48), and the two-part check of
     fused_conv.layer_check with each kernel's wrapper as the chain's
     forward, on the path's chain at 10 x 64^2 and on random chains at
     3 x 48^2 and at 2 x 96^2 (K1) or 2 x 32 x 48 (K2): every layer against
     float64 at relative RMS <= LAYER_BAR (3e-5), and the chain equal to its
     layers composed, bitwise. Their device ms a layer come from
     torch.profiler (K1's launch by launch in chain calls, K2's from
     one-layer chains), with Conv_1's TFLOP/s;
   - K2 in bf16, on the VAE decoder at 10 x 64^2: relative RMS <= 1e-3
     against K1's plain version in bf16 (the same order and roundings);
   - K1-bf16 (tensor cores, its own summation order) by the two-part check
     on the merged GZ pair at 10 x 64^2, a random merged pair at 3 x 48^2
     and a random single-group chain at 3 x 96^2 (two x-chunks a row). The
     chain's relative RMS against its plain version is printed, with no
     bar: the two sum in different orders, and flipped bf16 roundings
     cascade. Its per-layer device times come from torch.profiler, launch
     by launch in chain calls;
   - K3: exactly;
4. drive each path through run_ensemble, whose steady steps replay
   captured CUDA graphs (sim/graph.py): every launch count and the graph's
   step counts set to 0 just before it and read just after; a short
   warm-up, then a timed run with snapshots. A wrapper counts a call, and a
   replay calls none, so each path's kernel must count one call a closure
   call run eagerly or captured (K3 once, when the model resolves "dxb"),
   and no other chain kernel. Beside it, an eager timed run of the same
   model and step count (the step loop of make_online_step), which must
   equal the graphed run bitwise (the same AR1 generator seed);
5. right after each path's runs, where a step of it spends its time, for
   the eager step and for the graphed step (sim.graph.GraphedStep, its
   graphs captured first): the host clock over an untraced window; the
   host's time to enqueue a step and the card's time a step, a few steps
   queued behind a sleeping kernel, then run back to back; and a window
   traced by torch.profiler, with device time and launches a step by kernel
   group, the host's time by operation, and the union of the kernel
   intervals over the window's device span. The path's chain kernel must
   launch 7 times a step (K1, K1-bf16: a launch a layer) or once (K2), in
   the eager and in the replayed step;
6. each path graphed against eager on the card: 2 members x 64^2, 20 steps
   (the AB3 start, both diagnostics graphs and replays of each), with frozen
   noise and with AR1 white noise from one generator seed: q, the noise and
   the diagnostics' sums equal the eager step loop's bitwise at every step;
7. the drivers beyond run_ensemble on the main path, at 24 steps:
   run_simulation, run_with_snapshots (each snapshot equal to
   run_simulation's, bitwise), advance_run twice against once for twice the
   snapshots (bitwise, the time coordinate shifted) and
   run_ensemble_segmented against run_ensemble (bitwise), each replaying
   graphs;
8. after all timings, hold each path on the card (2 members, 10 steps, the
   same frozen noise) to 2e-5*max|q| (see F32_BOUND): a float32 path against
   the same path on the CPU, and the GZ path in float32 against the CPU.
   The bf16 path (GZ): from its carry at step 0 and at step 10, one step
   with K1-bf16 and one with its plain version patched in must hand the
   chain bitwise the same input, and on that input every layer passes the
   per-layer check and the chain equals its layers composed. Its 10-step
   distance from the same path with the plain version patched in, and from
   the CPU, are printed; the latter is held to a coarse bound only (see
   BF16_COARSE);
9. every closure of the JAX package, each on the card at full width through
   run_ensemble (10 members, AR1, diagnostics on, ZOO_STEPS steps graphed,
   dt = 14400 s): the GAN r4_eddy_gan_64_op1_s0 after use_optimal_epoch()
   (K1) and eddy_gan_48_op1_stable after use_stable_epoch() (K1, 48^2); the
   VAE r4_eddy_vae_64_op1_s0 after use_optimal_epoch() with "packed" (K2); a
   div=True GAN (K1) and a div=True VAE (K2) on seeded weights at the
   published widths 128/64/32x5, their chains 4 wide; a DeepInversion GAN,
   OLS and the bottleneck VAE on seeded weights (cuDNN, as the twin's XLA);
   the ANN ann_eddy_jet; and every physical closure by name. For each: q
   finite, steps replayed, the kernel's calls one a step run eagerly or
   captured where it has one, and 2 members x 10 frozen-noise steps against
   the same closure on the CPU to F32_BOUND; a second run gives its
   member-steps/s, a reading. Before them: K1 and K2 on the div chain (the
   4-wide last layer runs the narrow tile, as the 2-wide one does) against
   their plain versions and by the per-layer check; and a checkpoint switch
   on the card, which changes the forcing, and after which a GraphedStep
   held across it captures anew.
It prints a JSON line of the step profiles, one of phase 9's readings, one
of kernel measurements, then the nvidia-smi line, and last {"ok": true,
"device": {...}}. In the kernel
line, launches is the path's wrapper calls in phase 4's graphed runs, and
graph_replays the replayed steps there, each of which launches the kernel
as an eager step does; max_abs_err is max|kernel - plain| at the path's
shapes; for K1-bf16, which sums in its own order, the largest per-layer
max|K1-bf16 - float64|, and its extra library_grouped_ms times cuDNN with
groups=2. K1 and K2 carry layer_ms, their device ms a layer, and K2 its bf16
reading.

Run from the repository root: python3 chip_smoke.py
Where CUDA is not available it exits with code 1 and prints no result.
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
MODELS = ROOT / "trained_models"
FOLDER = str(MODELS / "eddy_gan_64")
DEV = "cuda"
MEMBERS, NX = 10, 64
WARMUP_STEPS, STEPS, SNAP_EVERY = 12, 300, 50
PROFILE_STEPS, QUEUED_STEPS = 30, 5  # 5 steps of ~104 launches stay well
#                                      within the card's launch queue
# name -> (folder, load_model overrides, the count its chain kernel adds to,
# the chain kernel's group in a trace (_group), its launches a step)
PATHS = {
    "gan": (FOLDER, {}, "launches", "K1 (Conv_1..Conv_7)", 7),
    "gz": (str(MODELS / "r4_eddy_gz_64_op1_s0"),
           {"inference_dtype": "bfloat16", "online_variant": "dxbpair"},
           "launches_bf16", "K1-bf16 (Conv_1..Conv_7)", 7),
    "vae": (str(MODELS / "r4_eddy_vae_64_op1_s0"),
            {"online_variant": "packed"}, "launches_packed",
            "K2 (Conv_1..Conv_7)", 1),
}
GRAPH_COUNTS = ("eager_steps", "captured_steps", "replayed_steps")
DRIVER_STEPS, DRIVER_SNAP = 24, 6  # phase 7
# |card - reference| / max|q| after 10 frozen-noise steps: float32 paths
# differ by float32 rounding alone. In bf16 a float32 sum taken in another
# order flips bf16 roundings, and the GZ mean net's output, a small
# difference of large activations, amplifies them to the size of bf16's own
# error; so the bf16 path is held by the per-layer check on its real chain
# inputs, and its distance from the CPU only to BF16_COARSE times the CPU's
# own bf16-versus-float32 distance, which catches a blow-up and no more.
F32_BOUND, BF16_COARSE = 2e-5, 2.0
# phase 9: steps of each closure's run, its snapshot interval, the folders
# of the closures on seeded weights (under an ignored build directory), and
# the physical closures' arguments beside their defaults (Laplace's default
# viscosity is 0)
ZOO_STEPS, ZOO_SNAP = 100, 50
ZOO_DIR = ROOT / "build" / "phase9_models"
PHYSICAL_ARGS = {"Laplace": {"nu": 100.0}}
COUNTS = ("launches", "launches_bf16", "launches_packed", "launches_probe")
LIBRARIES = ("fused_conv", "packed_chain", "bitcast_probe")
# peak rates and memory rate of one H100 SXM (NVIDIA data sheet, 700 W):
# float32 outside the tensor cores (K1 and K2 in float32), dense bf16 on the
# tensor cores (the bound of K1-bf16's function), HBM
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of fn() on the card, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=50):
    """Host time to enqueue one fn() call, the card running behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def random_folded(rng, hidden=(128, 64, 32, 32, 32, 32, 32),
                  kernels=(5, 5, 3, 3, 3, 3, 3, 3), n_in=4):
    chans = [n_in] + list(hidden) + [2]
    return {"params": {f"Conv_{i}": {
        "kernel": (rng.standard_normal((k, k, chans[i], chans[i + 1]))
                   / np.sqrt(k * k * chans[i])).astype(np.float32),
        "bias": 0.1 * rng.standard_normal(chans[i + 1]).astype(np.float32)}
        for i, k in enumerate(kernels)}}


def kernel_row(name, source, replaces, err, ms, plain_ms, flops, nbytes,
               peak_flops, library_ms):
    """One entry of the kernels line; `launches` is filled in by phase 4."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda",
            "source": f"pyqg_generative_torch/csrc/{source}",
            "replaces": f"pyqg_generative_tpu/ml/pallas_conv.py:{replaces}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def float64_chain(x, packed):
    """The chain in float64 on the kernel's input, as a third opinion."""
    from pyqg_generative_torch.ml.nets import circular_conv2d
    act = x.double().permute(0, 3, 1, 2)
    for i, (w, b) in enumerate(zip(packed.weights, packed.biases)):
        act = circular_conv2d(act, w.double(), b.double())
        act = torch.relu(act) if i < len(packed.weights) - 1 else act
    return act.permute(0, 2, 3, 1)


def library_chain(x, weights, biases, groups=None):
    """The same chain as cuDNN convolutions on NCHW input, in the weights'
    dtype, each layer with its `groups` (OIHW weights of I = cin/groups),
    dense if None (timed only)."""
    import torch.nn.functional as F
    act = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        r = w.shape[-1] // 2
        act = F.conv2d(F.pad(act, (r, r, r, r), mode="circular"), w, b,
                       groups=groups[i] if groups else 1)
        if i < len(weights) - 1:
            act = torch.relu(act)
    return act


def grouped_weights(w, G):
    """The G diagonal blocks of a dense OIHW kernel, as conv2d's grouped
    (cout, cin/G, K, K)."""
    co, ci = w.shape[0] // G, w.shape[1] // G
    return torch.cat([w[g * co:(g + 1) * co, g * ci:(g + 1) * ci]
                      for g in range(G)])


def library_pack(x):
    """K3's function as one PyTorch call: the row pairs (2i, 2i+1) of a
    (2R, C) bf16 tensor stacked and viewed as (R, C) int32 words; on a
    little-endian card row 2i lands in the low half (timed and compared
    only)."""
    return torch.stack((x[0::2], x[1::2]), -1).view(torch.int32)[..., 0]


def chain_input(fused_conv, folded, B, H, seed, dtype=torch.float32,
                W=None):
    """(packed chain, its input: Conv_0's output of a random field on
    B x H x W, W = H unless given)."""
    apply = fused_conv.make_online_cnn(folded, dtype, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    n_in = folded["params"]["Conv_0"]["kernel"].shape[2]
    return apply.packed, apply.first_layer(torch.randn(
        (B, H, W or H, n_in), generator=gen, device=DEV))


def rel_rms(out, ref):
    return float(((out - ref) ** 2).mean().sqrt() / (ref ** 2).mean().sqrt())


def check_k1(fused_conv, folded, B, H, seed, W=None):
    """K1 in float32 against its plain version on Conv_0's output of a
    random input; returns (packed, K1 input, max |K1 - plain|)."""
    packed, x = chain_input(fused_conv, folded, B, H, seed, W=W)
    out = fused_conv.fused_cnn_forward(x, packed)
    torch.cuda.synchronize()
    ref = fused_conv.fused_cnn_forward_plain(x, packed)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    ref64 = float64_chain(x, packed)
    ok = torch.allclose(out, ref, rtol=2e-4, atol=2e-5 * scale)
    log(f"K1 vs plain at B={B}, {H}^2: max|err| {err:.3e}, max|ref| "
        f"{scale:.3e}, within rtol 2e-4 / atol 2e-5*max: {ok}; against "
        f"float64 of the same weights: K1 "
        f"{float((out.double() - ref64).abs().max()):.3e}, plain "
        f"{float((ref.double() - ref64).abs().max()):.3e}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"B={B}, {H}^2")
    return packed, x, err


def check_layers(fused_conv, name, packed, x, what):
    """A chain kernel (`name`: K1-bf16, K1 or K2) by the two-part check of
    fused_conv.layer_check on x, with its wrapper as the chain's forward;
    raises if a layer misses LAYER_BAR or the chain differs from its layers
    composed. Returns the largest per-layer max|kernel - float64|."""
    forward, plain_fn, count = {
        "K1-bf16": (fused_conv.fused_cnn_forward,
                    fused_conv.fused_cnn_forward_plain, "launches_bf16"),
        "K1": (fused_conv.fused_cnn_forward,
               fused_conv.fused_cnn_forward_plain, "launches"),
        "K2": (fused_conv.packed_cnn_forward,
               fused_conv.packed_cnn_forward_plain, "launches_packed")}[name]
    before = getattr(fused_conv, count)
    rep = fused_conv.layer_check(x, packed, forward)
    torch.cuda.synchronize()
    n = len(packed.meta)
    if getattr(fused_conv, count) != before + 2 * n + 1:
        raise AssertionError(f"{name} did not launch once a call")
    bar = fused_conv.LAYER_BAR
    for i, ((rel, err, plain), meta, g) in enumerate(zip(
            rep["layers"], packed.meta, packed.groups)):
        log(f"{name}, {what}, layer {i + 1} (K, cin, cout) {meta} in {g} "
            f"group(s): against float64 relative RMS {rel:.3e} (bar "
            f"{bar:.0e}), max|err| {err:.3e}; plain version's max|err| "
            f"{plain:.3e}")
    worst = max(rel for rel, _, _ in rep["layers"])
    chain = forward(x, packed)
    reading = rel_rms(chain, plain_fn(x, packed))
    log(f"{name}, {what}: chain equals its layers composed bitwise: "
        f"{rep['composed_equal']}; the chain against its plain version (a "
        f"reading, no bar): relative RMS {reading:.3e}")
    if not worst <= bar:
        raise AssertionError(f"{name}, {what}: a layer reads relative RMS "
                             f"{worst:.3e} against float64, over {bar}")
    if not rep["composed_equal"]:
        raise AssertionError(f"{name}, {what}: the chain differs from its "
                             "layers composed")
    return max(err for _, err, _ in rep["layers"])


def launch_ms(call, kernel, n=1, calls=10, windows=3):
    """Mean device ms of each of the n launches of `kernel` (a substring of
    the kernel's name) that call() makes in turn, by torch.profiler over
    `calls` calls: the j-th launch of every call is counted as launch j. On
    an H100 the profiler has missed one launch of a window, and once every
    launch of a process's first window; as launches are told apart by their
    order, a window that did not see n launches a call is traced again, up
    to `windows` times."""
    call()
    torch.cuda.synchronize()
    for _ in range(windows):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name), key=lambda e: e.time_range.start)]
        if len(us) == n * calls:
            return [sum(us[j::n]) / calls / 1e3 for j in range(n)]
        log(f"the profiler saw {len(us)} launches of {kernel} in {calls} "
            f"calls of {n}; tracing the window again")
    raise AssertionError(f"the profiler saw {len(us)} launches of {kernel} "
                         f"in {calls} calls of {n}, {windows} windows "
                         "running")


def chain_layer_ms(fused_conv, name, packed, x):
    """Device ms of each layer of a chain kernel (`name`: K1, K1-bf16 or
    K2) on x. K1 launches once a layer, so its layers are read off chain
    calls, launch by launch: the path's own kernels. K2 runs the chain in
    one launch, so each layer is run alone, as a one-layer chain
    (chain_layer) on its input as the plain chain computes it: without the
    chain's grid-wide barriers, and on min(the resident grid, the layer's
    work items) blocks, which for a layer of fewer items than the resident
    grid (the 2-channel last layer: 80) is fewer than the chain's."""
    if name != "K2":
        kernel = "conv_mma_kernel" if name == "K1-bf16" \
            else "conv_fma_kernel"
        return launch_ms(lambda: fused_conv.fused_cnn_forward(x, packed),
                         kernel, len(packed.meta))
    ms, act = [], x
    for i in range(len(packed.meta)):
        one = fused_conv.chain_layer(packed, i)
        ms += launch_ms(
            lambda a=act, o=one: fused_conv.packed_cnn_forward(a, o),
            "packed_chain_kernel")
        act = torch.relu(fused_conv.fused_cnn_forward_plain(act, one))
    return ms


def f32_layer_ms(fused_conv, name, packed, x):
    """Device ms a layer of K1 or K2 in float32 (chain_layer_ms); logs them
    with Conv_1's TFLOP/s and its share of the float32 peak."""
    ms = chain_layer_ms(fused_conv, name, packed, x)
    B, H, W, _ = x.shape
    tflops = fused_conv.flops_per_member(packed.meta[:1], H, W) * B \
        / (ms[0] * 1e-3) / 1e12
    log(f"{name} float32 at {B} x {H} x {W}, device ms a layer (K, cin, "
        "cout): " + "; ".join(f"{m} {t:.4f}" for m, t in
                              zip(packed.meta, ms))
        + f"; sum {sum(ms):.4f}; Conv_1 {tflops:.2f} TFLOP/s, "
        f"{100 * tflops * 1e12 / PEAK_FP32_FLOPS:.1f}% of the float32 peak")
    return ms


def check_k2(fused_conv, folded, B, H, seed, W=None):
    """K2 against its plain version on Conv_0's output of a random input,
    NHWC; returns (packed, K2 input, max |K2 - plain|)."""
    packed, x = chain_input(fused_conv, folded, B, H, seed, W=W)
    out = fused_conv.packed_cnn_forward(x, packed)
    torch.cuda.synchronize()
    ref = fused_conv.packed_cnn_forward_plain(x, packed)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    ok = torch.allclose(out, ref, rtol=2e-4, atol=2e-5 * scale)
    k1 = fused_conv.fused_cnn_forward_plain(x, packed)
    log(f"K2 vs plain at B={B}, {H}x{W or H}: max|err| {err:.3e}, max|ref| "
        f"{scale:.3e}, within rtol 2e-4 / atol 2e-5*max: {ok}; K2 vs K1's "
        f"plain version {float((out - k1).abs().max()):.3e}")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"B={B}, {H}x{W or H}")
    return packed, x, err


def check_k2_bf16(fused_conv, folded, B, H, seed):
    """K2's bf16 entry on the chain packed in bf16: relative RMS <= 1e-3
    against K1's plain version in bf16, which sums each output in the
    kernel's order and rounds at the same places (K2's own plain version
    sums in another order, and flipped bf16 roundings cascade over the
    chain); returns the reading."""
    packed, x = chain_input(fused_conv, folded, B, H, seed, torch.bfloat16)
    before = fused_conv.launches_packed
    out = fused_conv.packed_cnn_forward(x, packed)
    torch.cuda.synchronize()
    if fused_conv.launches_packed != before + 1:
        raise AssertionError("K2-bf16 did not launch once")
    rel = rel_rms(out, fused_conv.fused_cnn_forward_plain(x, packed))
    log(f"K2-bf16 at B={B}, {H}^2 against K1's plain version in bf16: "
        f"relative RMS {rel:.3e} (bar 1e-3); against its own plain version "
        f"(a reading) {rel_rms(out, fused_conv.packed_cnn_forward_plain(x, packed)):.3e}")
    if not rel <= 1e-3:
        raise AssertionError("K2-bf16 disagrees with K1's plain version")
    return rel


def check_and_time_kernels(fused_conv, smi):
    """Phase 3: every kernel against its plain version, and its times.
    Returns the kernels line's entries by path-kernel name."""
    from pyqg_generative_torch.ml.nets import fold_batchnorm
    from pyqg_generative_torch.ml.weights import read_msgpack
    rows = {}
    rng = np.random.default_rng(2)

    # K1, float32: eddy_gan_64 at the main path's shapes
    gan = fold_batchnorm(read_msgpack(f"{FOLDER}/G.msgpack"))
    packed, x, err = check_k1(fused_conv, gan, MEMBERS, NX, seed=1)
    check_k1(fused_conv, random_folded(rng), 3, 48, seed=2)
    # the per-layer check: the path's chain, a random chain at 3 x 48^2 (a
    # ragged second tile a row) and at 2 x 96^2 (three tiles a row)
    check_layers(fused_conv, "K1", packed, x,
                 f"eddy_gan_64 at {MEMBERS} x {NX}^2")
    for B, H, seed in ((3, 48, 8), (2, 96, 9)):
        check_layers(fused_conv, "K1", *chain_input(
            fused_conv, random_folded(rng), B, H, seed),
            f"random chain at {B} x {H}^2")
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    k1_args = (x, packed)
    rows["k1"] = kernel_row(
        "k1_fused_cnn_forward_f32", "fused_conv.cu", 396, err,
        cuda_ms(lambda: fused_conv.fused_cnn_forward(x, packed)),
        cuda_ms(lambda: fused_conv.fused_cnn_forward_plain(x, packed)),
        fused_conv.flops_per_member(packed.meta, NX, NX) * MEMBERS,
        4 * (x.numel() + MEMBERS * NX * NX * packed.meta[-1][2]
             + packed.wflat.numel() + packed.bflat.numel()),
        PEAK_FP32_FLOPS,
        cuda_ms(lambda: library_chain(x_nchw, packed.weights,
                                      packed.biases)))
    rows["k1"]["layer_ms"] = f32_layer_ms(fused_conv, "K1", packed, x)

    # K1-bf16: the merged GZ mean/variance pair at path 2's shapes
    gz = PATHS["gz"][0]
    pair = fused_conv.merge_folded_pair(*(
        fold_batchnorm(read_msgpack(f"{gz}/{n}.msgpack"))
        for n in ("net_mean", "net_var")))
    packed, x = chain_input(fused_conv, pair, MEMBERS, NX, 3, torch.bfloat16)
    err = check_layers(fused_conv, "K1-bf16", packed, x,
                       f"merged GZ pair at {MEMBERS} x {NX}^2")
    for folded, B, H, seed, what in (
            (fused_conv.merge_folded_pair(random_folded(rng, n_in=2),
                                          random_folded(rng, n_in=2)),
             3, 48, 4, "random merged pair at 3 x 48^2"),
            (random_folded(rng), 3, 96, 7,
             "random single-group chain at 3 x 96^2")):
        check_layers(fused_conv, "K1-bf16", *chain_input(
            fused_conv, folded, B, H, seed, torch.bfloat16), what)
    k1_bf16_args = (x, packed)
    x_bf = x.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    w_bf = [w.to(torch.bfloat16) for w in packed.weights]
    b_bf = [b.to(torch.bfloat16) for b in packed.biases]
    wg_bf = [grouped_weights(w, g) for w, g in zip(w_bf, packed.groups)]
    flops = fused_conv.flops_per_member(packed.meta, NX, NX) * MEMBERS
    # the merged weights are block-diagonal: the bound counts the
    # operations on nonzero weights, the work this input needs
    nonzero = 2.0 * NX * NX * MEMBERS * sum(
        int((w != 0).sum()) for w in packed.weights)
    rows["k1_bf16"] = kernel_row(
        "k1_fused_cnn_forward_bf16", "fused_conv.cu", 396, err,
        cuda_ms(lambda: fused_conv.fused_cnn_forward(x, packed)),
        cuda_ms(lambda: fused_conv.fused_cnn_forward_plain(x, packed)),
        nonzero,
        4 * (x.numel() + MEMBERS * NX * NX * packed.meta[-1][2]
             + packed.bflat.numel()) + 2 * packed.wflat.numel(),
        PEAK_BF16_FLOPS,
        cuda_ms(lambda: library_chain(x_bf, w_bf, b_bf)))
    rows["k1_bf16"]["library_grouped_ms"] = cuda_ms(
        lambda: library_chain(x_bf, wg_bf, b_bf, packed.groups))
    ms = chain_layer_ms(fused_conv, "K1-bf16", packed, x)
    log(f"K1-bf16 on the merged pair: {flops / 1e9:.3f} GFLOP a call, "
        f"{nonzero / 1e9:.3f} GFLOP of it on nonzero weights; groups "
        f"{packed.groups}; device ms a call by torch.profiler: the 5x5 "
        f"layer {ms[0]:.4f}, the 3x3 layers {sum(ms[1:]):.4f}"
        f"; cuDNN with groups {rows['k1_bf16']['library_grouped_ms']:.4f} "
        f"ms on {smi}")

    # K2: the VAE decoder at path 3's shapes, NHWC
    vae = fold_batchnorm(read_msgpack(f"{PATHS['vae'][0]}/decoder.msgpack"))
    packed, x, err = check_k2(fused_conv, vae, MEMBERS, NX, seed=5)
    check_k2(fused_conv, random_folded(rng), 3, 48, seed=6)
    check_k2(fused_conv, random_folded(rng), 2, 32, seed=10, W=48)
    # the per-layer check: the path's chain, a random chain at 3 x 48^2 and
    # at 2 x 32 x 48 (a grid that is not square)
    check_layers(fused_conv, "K2", packed, x,
                 f"the VAE decoder at {MEMBERS} x {NX}^2")
    for B, H, W, seed in ((3, 48, 48, 11), (2, 32, 48, 12)):
        check_layers(fused_conv, "K2", *chain_input(
            fused_conv, random_folded(rng), B, H, seed, W=W),
            f"random chain at {B} x {H} x {W}")
    k2_bf16 = check_k2_bf16(fused_conv, vae, MEMBERS, NX, seed=13)
    k2_args = (x, packed)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    rows["k2"] = kernel_row(
        "k2_packed_cnn_forward_f32", "packed_chain.cu", 485, err,
        cuda_ms(lambda: fused_conv.packed_cnn_forward(x, packed)),
        cuda_ms(lambda: fused_conv.packed_cnn_forward_plain(x, packed)),
        fused_conv.flops_per_member(packed.meta, NX, NX) * MEMBERS,
        4 * (x.numel() + MEMBERS * NX * NX * packed.meta[-1][2]
             + packed.wflat.numel() + packed.bflat.numel()),
        PEAK_FP32_FLOPS,
        cuda_ms(lambda: library_chain(x_nchw, packed.weights,
                                      packed.biases)))
    rows["k2"]["layer_ms"] = f32_layer_ms(fused_conv, "K2", packed, x)
    rows["k2"]["bf16_rel_rms_vs_k1_plain"] = k2_bf16

    # K3: exact, on the probe's input and on random bf16, against its plain
    # version and against the library's packing
    probe = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.bfloat16,
                         device=DEV)[:, None].expand(4, 128).contiguous()
    for xb in (torch.randn((4, 128), device=DEV).to(torch.bfloat16), probe):
        before = fused_conv.launches_probe
        words = fused_conv.bitcast_pack_words(xb)
        torch.cuda.synchronize()
        if words.dtype != torch.int64 or \
                fused_conv.launches_probe != before + 1:
            raise AssertionError("K3: not one launch of int64 words")
        if not torch.equal(words, fused_conv.bitcast_pack_words_plain(xb)):
            raise AssertionError("K3 disagrees with its plain version")
        if not torch.equal(words, library_pack(xb).to(torch.int64)
                           & 0xFFFFFFFF):
            raise AssertionError("K3 disagrees with the library's packing")
    log(f"K3 vs plain and vs torch.stack(...).view(int32): exact; probe "
        f"words {int(words[0, 0]):#010x} {int(words[1, 0]):#010x} for rows "
        "(1, 2), (3, 4)")
    rows["k3"] = kernel_row(
        "k3_pack_bf16_pairs", "bitcast_probe.cu", 308, 0.0,
        cuda_ms(lambda: fused_conv.bitcast_pack_words(probe)),
        cuda_ms(lambda: fused_conv.bitcast_pack_words_plain(probe)),
        0.0, 2 * probe.numel() + 4 * probe.numel() // 2, PEAK_BF16_FLOPS,
        cuda_ms(lambda: library_pack(probe)))

    calls = {"k1": lambda: fused_conv.fused_cnn_forward(*k1_args),
             "k1_bf16": lambda: fused_conv.fused_cnn_forward(*k1_bf16_args),
             "k2": lambda: fused_conv.packed_cnn_forward(*k2_args),
             "k3": lambda: fused_conv.bitcast_pack_words(probe)}
    for key, r in rows.items():
        lib = "packing" if key == "k3" else "dense cuDNN chain"
        log(f"{r['name']}: {r['ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
            f"{lib} {r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); the host enqueues a call in "
            f"{host_ms(calls[key]):.4f} ms; on {smi}")
    return rows


def set_counts(fused_conv, graph):
    """Every launch count and the graph's step counts to 0."""
    for c in COUNTS:
        setattr(fused_conv, c, 0)
    for c in GRAPH_COUNTS:
        setattr(graph, c, 0)


def read_counts(fused_conv, graph):
    return ({c: getattr(fused_conv, c) for c in COUNTS},
            {c: getattr(graph, c) for c in GRAPH_COUNTS})


def eager_ensemble(p, closure, n_ens, steps_per_snap, n_snaps, key=0):
    """run_ensemble's run, from its start and generator seed, by the eager
    step loop of make_online_step: snapshots and diagnostics to the host, as
    a Dataset."""
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    from pyqg_generative_torch.sim import simulate
    model = closure["self"]
    q0 = torch.stack([simulate.set_initial_condition(p, key * 1000 + j)
                      for j in range(n_ens)])
    carry = init_run_carry(p, q0, key, model, device=DEV)
    step = make_online_step(p, model, closure["sampling"], closure["nsteps"])
    snaps = []
    for _ in range(n_snaps):
        for _ in range(steps_per_snap):
            carry = step(carry)
        snaps.append(simulate._snapshot(carry[0], p))
    snaps = {k: torch.stack([s[k] for s in snaps], 1).cpu().numpy()
             for k in snaps[0]}
    diags = {k: v.cpu().numpy() for k, v in
             simulate.diagnostics.finalize(carry[2]).items()}
    return simulate._build_dataset(snaps, diags, p, steps_per_snap * p.dt,
                                   n_snaps, run_dim=True)


def same_dataset(a, b):
    """Whether two Datasets hold the same variables, bitwise."""
    return sorted(a.keys()) == sorted(b.keys()) and all(
        np.array_equal(a[k].values, b[k].values) for k in a.keys())


def drive_path(name, fused_conv, graph, p):
    """Phase 4 for one path: counts zeroed, the model loaded, a warm-up and
    a timed run through run_ensemble (graphed); then an eager timed run of
    the same steps, which must equal it bitwise. Returns (model, the graphed
    run's launch counts and graph counts, its rate, the eager rate)."""
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.sim import run_ensemble
    folder, kw, count, *_ = PATHS[name]
    set_counts(fused_conv, graph)
    # the probe is cached per process; a fresh process resolves "dxb" anew
    fused_conv.bitcast_packing.cache_clear()
    model = load_model(folder, device=DEV, **kw)
    closure = {"self": model, "sampling": "AR1", "nsteps": 1}
    run_ensemble(p.replace(tmax=WARMUP_STEPS * p.dt), closure,
                 n_ens=MEMBERS, sampling_freq=WARMUP_STEPS * p.dt,
                 device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = run_ensemble(p.replace(tmax=STEPS * p.dt), closure, n_ens=MEMBERS,
                      sampling_freq=SNAP_EVERY * p.dt, device=DEV)
    wall = time.perf_counter() - t0
    counts, steps = read_counts(fused_conv, graph)
    calls = WARMUP_STEPS + STEPS
    want = {c: 0 for c in COUNTS}
    want[count] = steps["eager_steps"] + steps["captured_steps"]
    if name == "gz":
        want["launches_probe"] = 1
    if counts != want or steps["eager_steps"] + steps["replayed_steps"] \
            != calls or steps["replayed_steps"] < STEPS:
        raise AssertionError(f"{name}: launch counts {counts} and graph "
                             f"counts {steps} in {calls} steps, expected "
                             f"{want} and every steady step replayed")
    n_snaps = STEPS // SNAP_EVERY
    for k in ("q", "u", "v", "psi"):
        v = ds[k].values
        if v.shape != (MEMBERS, n_snaps, 2, NX, NX) or \
                not np.isfinite(v).all():
            raise AssertionError(f"{name} {k}: shape {v.shape} or "
                                 "non-finite")
    for k in ("KEspec", "Ensspec", "KEflux", "APEflux", "paramspec",
              "ENSparamspec", "Dissspec"):
        if not np.isfinite(ds[k].values).all():
            raise AssertionError(f"{name}: diagnostic {k} is not finite")
    if not (ds["KEspec"].values > 0).any():
        raise AssertionError(f"{name}: no kinetic energy accumulated")
    rate = MEMBERS * STEPS / wall

    set_counts(fused_conv, graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = eager_ensemble(p.replace(tmax=STEPS * p.dt), closure, MEMBERS,
                           SNAP_EVERY, n_snaps)
    eager_wall = time.perf_counter() - t0
    eager_counts, eager_steps = read_counts(fused_conv, graph)
    want = {c: 0 for c in COUNTS}
    want[count] = STEPS
    if eager_counts != want or any(eager_steps.values()):
        raise AssertionError(f"{name}: the eager run's counts "
                             f"{eager_counts}, {eager_steps}; expected "
                             f"{want} and no graph")
    if not same_dataset(ds, eager):
        raise AssertionError(f"{name}: the graphed run differs from the "
                             "eager step loop")
    eager_rate = MEMBERS * STEPS / eager_wall
    log(f"path {name}: {MEMBERS} members x {STEPS} steps at {NX}^2, "
        f"graphed: {wall:.3f} s = {rate:.1f} member-steps/s, launch counts "
        f"over load, warm-up and run {counts}, graph counts {steps}; eager: "
        f"{eager_wall:.3f} s = {eager_rate:.1f} member-steps/s; the two "
        f"runs equal bitwise; std(q) {ds['q'].values[:, -1].std():.3e}")
    return model, counts, steps, rate, eager_rate


def graphed_vs_eager(name, model, p, graph):
    """Phase 6 for one path: 2 members, 20 steps, graphed (GraphedStep)
    against the eager step loop, with frozen noise and with AR1 white noise
    from one generator seed; q, the noise and the diagnostics' sums must be
    equal bitwise at every step. Returns the steps replayed."""
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    q0 = np.stack([core.default_initial_q(
        p, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    replayed = 0
    for nsteps in (-1, 1):
        eager = init_run_carry(p, q0, 7, model, device=DEV)
        graphed = init_run_carry(p, q0, 7, model, device=DEV)
        step = make_online_step(p, model, "AR1", nsteps)
        gstep = graph.GraphedStep(p, model, "AR1", nsteps)
        before = graph.replayed_steps
        for i in range(20):
            eager, graphed = step(eager), gstep(graphed)
            same = [torch.equal(eager[0].qh, graphed[0].qh),
                    torch.equal(eager[1].noise, graphed[1].noise),
                    all(torch.equal(v, graphed[2].sums[k])
                        for k, v in eager[2].sums.items())]
            if not all(same):
                dq = (eager[0].qh - graphed[0].qh).abs().max()
                dz = (eager[1].noise - graphed[1].noise).abs().max()
                raise AssertionError(
                    f"path {name}, AR1({nsteps}), step {i}: graphed and "
                    f"eager differ (qh, noise, sums equal: {same}); "
                    f"max|qh diff| {float(dq):.3e}, max|noise diff| "
                    f"{float(dz):.3e}")
        host = [(c[0].t, c[0].tc, c[1].counter, c[2].count)
                for c in (eager, graphed)]
        if host[0] != host[1] or graph.replayed_steps - before < 10:
            raise AssertionError(f"path {name}, AR1({nsteps}): host values "
                                 f"{host}, {graph.replayed_steps - before} "
                                 "replays")
        replayed += graph.replayed_steps - before
        log(f"path {name}, 2 members x 20 steps, AR1({nsteps}): graphed "
            f"equals eager bitwise at every step (q, noise, diagnostics' "
            f"sums); {graph.replayed_steps - before} steps replayed from "
            f"{len(gstep._graphs)} graphs")
    return replayed


def drivers_on_card(model, p, graph):
    """Phase 7: the drivers beyond run_ensemble on the main path, each
    advancing its steady steps by replays."""
    from pyqg_generative_torch.sim import advance_run, init_run_carry, \
        run_ensemble, run_ensemble_segmented, run_simulation, \
        run_with_snapshots
    pd = p.replace(tmax=DRIVER_STEPS * p.dt)
    freq = DRIVER_SNAP * p.dt
    n_snaps = DRIVER_STEPS // DRIVER_SNAP
    closure = {"self": model, "sampling": "AR1", "nsteps": 1}
    replays = {}

    def replayed(what, fn):
        before = graph.replayed_steps
        out = fn()
        replays[what] = graph.replayed_steps - before
        if not replays[what]:
            raise AssertionError(f"{what} replayed no step")
        return out

    sim = replayed("run_simulation", lambda: run_simulation(
        pd, closure, sampling_freq=freq, key=3, device=DEV))
    if sim["q"].dims != ("time", "lev", "y", "x") or \
            sim["q"].shape != (n_snaps, 2, NX, NX) or \
            sim["KEspec"].dims != ("lev", "l", "k") or \
            not np.isfinite(sim["q"].values).all():
        raise AssertionError(f"run_simulation: {sim['q'].dims} "
                             f"{sim['q'].shape} {sim['KEspec'].dims}")
    snaps = replayed("run_with_snapshots", lambda: list(run_with_snapshots(
        pd, closure, sampling_freq=freq, key=3, device=DEV)))
    for i, (t, ds) in enumerate(snaps):
        if t != (i + 1) * freq or not np.array_equal(
                ds["q"].values[0], sim["q"].values[i]):
            raise AssertionError(f"run_with_snapshots, snapshot {i}: t {t} "
                                 "or q differs from run_simulation's")

    q0 = np.stack([sim["q"].values[0]] * 2).astype(np.float32)

    def advance(n, times):
        carry = init_run_carry(pd, q0, 5, model, device=DEV)
        out = []
        for _ in range(times):
            carry, ds = advance_run(carry, pd, closure, n_snaps=n,
                                    sampling_freq=freq, device=DEV)
            out.append(ds)
        return out

    two = replayed("advance_run x 2", lambda: advance(n_snaps // 2, 2))
    one = replayed("advance_run x 1", lambda: advance(n_snaps, 1))[0]
    for k in ("q", "u", "v", "psi"):
        joined = np.concatenate([two[0][k].values, two[1][k].values], 1)
        if not np.array_equal(joined, one[k].values):
            raise AssertionError(f"advance_run twice differs in {k}")
    times = np.concatenate([two[0]["time"].values, two[1]["time"].values])
    if not np.allclose(times, one["time"].values, rtol=1e-12, atol=0) or \
            not all(np.array_equal(two[1][k].values, one[k].values)
                    for k in one.keys()
                    if k not in ("q", "u", "v", "psi", "time")):
        raise AssertionError("advance_run twice: the time coordinate or "
                             "the diagnostics differ")
    whole = replayed("run_ensemble", lambda: run_ensemble(
        pd, closure, n_ens=2, sampling_freq=freq, key=4, device=DEV))
    seg = replayed("run_ensemble_segmented", lambda: run_ensemble_segmented(
        pd, closure, n_ens=2, sampling_freq=freq, key=4, n_segments=2,
        device=DEV))
    if not same_dataset(whole, seg):
        raise AssertionError("run_ensemble_segmented differs from "
                             "run_ensemble")
    log(f"drivers on the main path, {DRIVER_STEPS} steps at {NX}^2, AR1: "
        "run_with_snapshots equals run_simulation, advance_run twice equals "
        "it once, run_ensemble_segmented equals run_ensemble, bitwise; "
        f"steps replayed {replays}")
    return replays


def card_vs_reference(name, model, p, fused_conv):
    """Phase 8 for one path: |card - reference| / max|q| after 10
    frozen-noise steps of 2 members, against F32_BOUND (see there)."""
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    folder, kw, *_ = PATHS[name]
    pq = p.replace(taveint=2 * p.dt)
    q0 = np.stack([core.default_initial_q(
        pq, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    noise = np.random.default_rng(3).standard_normal(
        (2, NX, NX, 2)).astype(np.float32)

    def final_q(m, dev):
        step = make_online_step(pq, m, "AR1", -1)
        carry = init_run_carry(pq, q0, 0, m, device=dev)
        carry[1].noise = torch.from_numpy(noise).to(dev)
        for _ in range(10):
            carry = step(carry)
        return core.fields(carry[0].qh, pq).q.cpu().numpy()

    def held(what, out, ref, bound=F32_BOUND):
        scale = float(np.abs(ref).max())
        diff = float(np.abs(out - ref).max()) / scale
        log(f"path {name}, 2 members x 10 steps, {what}: max|diff| / max|q| "
            f"{diff:.3e} (max|q| {scale:.3e}, bound {bound:.3e})")
        if not diff <= bound:
            raise AssertionError(f"path {name}: {what} disagree")
        return diff

    card = final_q(model, DEV)
    cpu = final_q(load_model(folder, device="cpu", **kw), "cpu")
    if kw.get("inference_dtype") != "bfloat16":
        return held("card vs CPU", card, cpu)
    # the bf16 path: K1-bf16 sums in its own order, so one flipped bf16
    # rounding grows to bf16's whole error within 10 steps, and no path
    # distance can hold it. Instead, at steps 0 and 10 the chain's real
    # input is held: the same with the kernel and with its plain version
    # patched in (the model's chain looks the wrapper up at each call), and
    # passing the per-layer check there
    packed = model._online_fns()[0].packed
    step = make_online_step(pq, model, "AR1", -1)
    carry = init_run_carry(pq, q0, 0, model, device=DEV)
    carry[1].noise = torch.from_numpy(noise).to(DEV)
    kernel = fused_conv.fused_cnn_forward
    for at in range(11):
        if at in (0, 10):
            seen = {}
            for label, fn in (("kernel", kernel),
                              ("plain", fused_conv.fused_cnn_forward_plain)):
                def spy(x, p, _label=label, _fn=fn):
                    seen[_label] = x.clone()
                    return _fn(x, p)
                fused_conv.fused_cnn_forward = spy
                try:
                    step(carry)
                finally:
                    fused_conv.fused_cnn_forward = kernel
            if not torch.equal(seen["kernel"], seen["plain"]):
                raise AssertionError(f"path {name}: at step {at}, the kernel "
                                     "and its plain version see different "
                                     "chain inputs")
            log(f"path {name}, step {at}: the chain's input is bitwise the "
                "same with K1-bf16 and with its plain version")
            check_layers(fused_conv, "K1-bf16", packed, seen["kernel"],
                         f"path {name}'s chain input at step {at}")
        carry = step(carry)
    fused_conv.fused_cnn_forward = fused_conv.fused_cnn_forward_plain
    try:
        plain = final_q(model, DEV)
    finally:
        fused_conv.fused_cnn_forward = kernel
    diff = held("K1-bf16 vs its plain version, both on the card (a "
                "reading)", card, plain, bound=float("inf"))
    # the rest of the path in float32, card against CPU
    f32 = {**kw, "inference_dtype": "float32"}
    cpu32 = final_q(load_model(folder, device="cpu", **f32), "cpu")
    held("float32, card vs CPU", final_q(
        load_model(folder, device=DEV, **f32), DEV), cpu32)
    # a reading, held to a coarse bound only
    own = float(np.abs(cpu - cpu32).max()) / float(np.abs(cpu).max())
    log(f"path {name}: the CPU's bf16 run against its float32 run "
        f"{own:.3e} of max|q|")
    held("card vs CPU in bf16", card, cpu, BF16_COARSE * own)
    return diff


def seeded_folder(name, cls_name, modules, **args):
    """A model folder in the twin's contract, written by the port's
    save_variables and save_model_args: seeded weights of `modules` (file
    name -> module, ml.weights.seeded_variables) and eddy_gan_64's
    scalers."""
    from pyqg_generative_torch.ml.weights import seeded_variables
    from pyqg_generative_torch.models import save_model_args, save_variables
    path = ZOO_DIR / name
    path.mkdir(parents=True, exist_ok=True)
    for i, (fname, module) in enumerate(modules.items()):
        save_variables(seeded_variables(module, 90 + i),
                       str(path / f"{fname}.msgpack"))
    for s in ("x_scale.json", "y_scale.json"):
        (path / s).write_text((pathlib.Path(FOLDER) / s).read_text())
    save_model_args(cls_name, folder=str(path), **args)
    return str(path)


def zoo():
    """Phase 9's closures: name -> (make(device) -> model, the launch count
    its chain kernel adds to or None, grid size)."""
    from pyqg_generative_torch.ml import nets
    from pyqg_generative_torch.models import load_model, physical

    def switched(folder, switch, **kw):
        def make(dev):
            model = load_model(str(MODELS / folder), device=dev, **kw)
            if not getattr(model, switch)():
                raise AssertionError(f"{folder}: {switch}() found no file")
            return model
        return make

    def saved(folder, **kw):
        return lambda dev: load_model(folder, device=dev, **kw)

    hidden = list(nets.HIDDEN)
    out = {
        "gan_opt": (switched("r4_eddy_gan_64_op1_s0", "use_optimal_epoch"),
                    "launches", NX),
        "gan_stable": (switched("eddy_gan_48_op1_stable",
                                "use_stable_epoch"), "launches", 48),
        "vae_opt": (switched("r4_eddy_vae_64_op1_s0", "use_optimal_epoch",
                             online_variant="packed"), "launches_packed",
                    NX),
        "div_gan": (saved(seeded_folder(
            "div_gan", "CGANRegression",
            {"G": nets.AndrewCNN(4, 2, div=True)}, regression="None",
            nx=NX, generator="Andrew", div=True, hidden_channels=hidden)),
            "launches", NX),
        "div_vae": (saved(seeded_folder(
            "div_vae", "CVAERegression",
            {"decoder": nets.AndrewCNN(4, 2, div=True)}, regression="None",
            div=True, decoder_var="adaptive", hidden_channels=hidden),
            online_variant="packed"), "launches_packed", NX),
        "deep_inversion": (saved(seeded_folder(
            "deep_inversion", "CGANRegression",
            {"G": nets.DeepInversionGenerator(4, 2)}, regression="None",
            nx=NX, generator="DeepInversion", div=False,
            hidden_channels=hidden)), None, NX),
        "ols": (saved(seeded_folder(
            "ols", "OLSModel", {"net": nets.AndrewCNN(2, 2)}, div=False,
            batch_norm=True, bias=True, final_activation="None",
            hidden_channels=hidden)), None, NX),
        "bottleneck": (saved(seeded_folder(
            "bottleneck", "CVAEBottleneck",
            {"deep_decoder": nets.Upsampling(100, 4, 2, nx=NX),
             "decoder": nets.AndrewCNN(4, 2),
             "net_mean": nets.AndrewCNN(2, 2)}, regression="full_loss",
            nx=NX, div=False, decoder_var="adaptive", deep_latent=100)),
            None, NX),
        "ann_eddy_jet": (saved(str(MODELS / "ann_eddy_jet")), None, NX),
    }
    for name in physical.__all__:
        if name != "PhysicalParameterization":
            out[name] = (lambda dev, n=name: getattr(physical, n)(
                device=dev, **PHYSICAL_ARGS.get(n, {})), None, NX)
    return out


def div_chain_on_kernels(fused_conv, make):
    """A div=True chain (Conv_1..Conv_7, the last 4 wide) at 10 x 64^2
    through K1 and K2 against their plain versions (rtol 2e-4 / atol
    2e-5*max) and by the per-layer check."""
    from pyqg_generative_torch.ml.nets import fold_batchnorm
    folded = fold_batchnorm(make("cpu").vars_G)
    packed, x, err1 = check_k1(fused_conv, folded, MEMBERS, NX, seed=20)
    if packed.meta[-1][2] != 4:
        raise AssertionError(f"the div chain ends {packed.meta[-1]}")
    check_layers(fused_conv, "K1", packed, x, "the div chain")
    packed, x, err2 = check_k2(fused_conv, folded, MEMBERS, NX, seed=21)
    check_layers(fused_conv, "K2", packed, x, "the div chain")
    return {"k1_max_abs_err": err1, "k2_max_abs_err": err2}


def switch_on_card(graph, p):
    """A checkpoint switch on the card: the forcing of the same q and noise
    changes, and a GraphedStep held across the switch captures anew."""
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.sim import init_run_carry
    model = load_model(str(MODELS / "r4_eddy_gan_64_op1_s0"), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(4)
    q = 1e-5 * torch.randn((2, 2, NX, NX), generator=gen, device=DEV)
    z = torch.randn((2, NX, NX, 2), generator=gen, device=DEV)
    before = model(q, z)
    q0 = np.stack([core.default_initial_q(
        p, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    step = graph.GraphedStep(p, model, "AR1", -1)
    carry = init_run_carry(p, q0, 0, model, device=DEV)
    for _ in range(8):
        carry = step(carry)
    captured = graph.captured_steps
    if not model.use_optimal_epoch():
        raise AssertionError("no G_opt.msgpack")
    after = model(q, z)
    for _ in range(8):
        carry = step(carry)
    torch.cuda.synchronize()
    change = float((after - before).abs().max() / before.abs().max())
    recaptured = graph.captured_steps - captured
    log(f"checkpoint switch on the card: the forcing changes by {change:.3e} "
        f"of max|forcing|; the GraphedStep held across it captured "
        f"{recaptured} graph(s) anew")
    if not change > 1e-3 or recaptured < 1 or \
            not torch.isfinite(carry[0].qh).all():
        raise AssertionError("the checkpoint switch did not take on the card")
    return {"forcing_change": change, "recaptured": recaptured}


def every_closure(fused_conv, graph, p, smi):
    """Phase 9 (see the module's docstring). Returns its readings."""
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.sim import init_run_carry, make_online_step, \
        run_ensemble
    closures = zoo()
    readings = {"div_chain": div_chain_on_kernels(
        fused_conv, closures["div_gan"][0])}
    readings["switch"] = switch_on_card(graph, p)
    for name, (make, count, nx) in closures.items():
        pz = p.replace(nx=nx)
        model = make(DEV)
        closure = {"self": model, "sampling": "AR1", "nsteps": 1}

        def run():
            return run_ensemble(pz.replace(tmax=ZOO_STEPS * pz.dt), closure,
                                n_ens=MEMBERS,
                                sampling_freq=ZOO_SNAP * pz.dt, device=DEV)

        set_counts(fused_conv, graph)
        ds = run()
        counts, steps = read_counts(fused_conv, graph)
        want = {c: 0 for c in COUNTS}
        if count:
            want[count] = steps["eager_steps"] + steps["captured_steps"]
        q = ds["q"].values
        if counts != want or steps["replayed_steps"] < 1 or \
                steps["eager_steps"] + steps["replayed_steps"] != ZOO_STEPS:
            raise AssertionError(f"{name}: launch counts {counts}, graph "
                                 f"counts {steps}; expected {want} and "
                                 "steps replayed")
        if q.shape != (MEMBERS, ZOO_STEPS // ZOO_SNAP, 2, nx, nx) or \
                not np.isfinite(q).all():
            raise AssertionError(f"{name}: q of shape {q.shape} or "
                                 "not finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rate = MEMBERS * ZOO_STEPS / (time.perf_counter() - t0)

        # 2 members x 10 frozen-noise steps, card against CPU
        pq = pz.replace(taveint=2 * pz.dt)
        q0 = np.stack([core.default_initial_q(
            pq, rng=np.random.default_rng(j)).numpy() for j in range(2)])
        cpu_model = make("cpu")
        noise = cpu_model.generate_latent_noise(
            torch.Generator().manual_seed(3), nx, nx, (2,))

        def final_q(m, dev):
            step = make_online_step(pq, m, "AR1", -1)
            carry = init_run_carry(pq, q0, 0, m, device=dev)
            carry[1].noise = noise.to(dev)
            for _ in range(10):
                carry = step(carry)
            return core.fields(carry[0].qh, pq).q.cpu().numpy()

        card, cpu = final_q(model, DEV), final_q(cpu_model, "cpu")
        scale = float(np.abs(cpu).max())
        diff = float(np.abs(card - cpu).max()) / scale
        readings[name] = {"member_steps_per_s": rate, "card_vs_cpu": diff,
                          "graph_counts": steps, "launches": counts.get(
                              count) if count else None, "nx": nx}
        log(f"phase 9, {name} at {MEMBERS} x {nx}^2, {ZOO_STEPS} steps: "
            f"launch counts {counts}, graph counts {steps}; "
            f"{rate:.1f} member-steps/s (a reading, on {smi}); 2 members x "
            f"10 frozen-noise steps, card vs CPU max|diff| / max|q| "
            f"{diff:.3e} (bound {F32_BOUND:.0e})")
        if not diff <= F32_BOUND:
            raise AssertionError(f"{name}: the card and the CPU disagree")
    return readings


def _group(name: str) -> str:
    low = name.lower()
    if "conv_fma_kernel" in name:
        return "K1 (Conv_1..Conv_7)"
    if "conv_mma_kernel" in name:
        return "K1-bf16 (Conv_1..Conv_7)"
    if "packed_chain_kernel" in name:
        return "K2 (Conv_1..Conv_7)"
    if "fft" in low:  # before "conv": cuFFT's names hold "padding_t"
        return "cuFFT"
    if "conv" in low or "gemm" in low or "cudnn" in low:
        return "Conv_0 (cuDNN)"
    return "elementwise, reductions, copies"


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, (lo, hi) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > hi:
            total, lo, hi = total + hi - lo, s, e
        else:
            hi = max(hi, e)
    return total + hi - lo


def step_profile(step, carry):
    """Where a step's time goes, on one carry of a path (see phase 5 in the
    module's docstring). Returns a dict of ms a step and shares."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        carry = step(carry)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3

    # the card's own time for a few steps, the host's launches hidden
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(1_000_000)
    ev[1].record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e6 / ev[0].elapsed_time(ev[1])
    ev[0].record()
    torch.cuda._sleep(int(cycles_per_ms * max(50.0, 4 * QUEUED_STEPS
                                              * step_ms)))
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(QUEUED_STEPS):
        carry = step(carry)
    ev[2].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    hidden = enqueue_ms < 0.9 * sleep_ms
    queued_ms = ev[1].elapsed_time(ev[2]) / QUEUED_STEPS if hidden else None

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a window whose kernels the profiler missed (see
        #                 launch_ms) is traced again
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                carry = step(carry)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    if not kernels:
        raise AssertionError("the profiler saw no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    span_us = max(e for _, e in spans) - spans[0][0]
    groups, launches, by_name = {}, {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + us
        launches[_group(e.name)] = launches.get(_group(e.name), 0) + 1
        ms, calls = by_name.get(e.name[:80], (0.0, 0))
        by_name[e.name[:80]] = (ms + us / PROFILE_STEPS / 1e3, calls + 1)
    host = sorted(((e.key, e.self_cpu_time_total)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])
    return {
        "step_ms": step_ms,
        "queued_step_ms": queued_ms,
        "queued_enqueue_ms": enqueue_ms, "queued_sleep_ms": sleep_ms,
        "host_ms_per_step": enqueue_ms / QUEUED_STEPS,
        "host_limited_share": None if queued_ms is None
        else 1 - queued_ms / step_ms,
        "traced_step_ms": traced_ms,
        "traced_busy_share": _union_us(spans) / span_us,
        "traced_kernels_per_step": len(kernels) / PROFILE_STEPS,
        "traced_device_ms_per_step": {
            k: v / PROFILE_STEPS / 1e3 for k, v in sorted(
                groups.items(), key=lambda kv: -kv[1])},
        "traced_launches_per_step": {
            k: n / PROFILE_STEPS for k, n in sorted(launches.items())},
        "traced_host_top_ms_per_step": {
            k: us / PROFILE_STEPS / 1e3 for k, us in host[:8]},
        "traced_top_kernels_ms_calls_per_step": {
            k: [ms, calls / PROFILE_STEPS] for k, (ms, calls) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:8]}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from pyqg_generative_torch.ml import _build, fused_conv
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.qg.params import QGParams
    from pyqg_generative_torch.sim import graph, init_run_carry, \
        make_online_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # 2. build the kernels, one nvcc per library, all at once
    t0 = time.perf_counter()
    _build.build_libraries(LIBRARIES)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for lib in LIBRARIES:
        log(_build.library_path(lib).with_suffix(".log").read_text().strip())

    # 3. each kernel against its plain version, and its times
    rows = check_and_time_kernels(fused_conv, smi)

    # 4. the three paths, each with 5. its step profiles; 6. each path
    # graphed against eager; 7. the other drivers; then 8. each path
    # against the CPU, whose work would disturb the host's timings
    p = QGParams(nx=NX, dt=14400.0, tavestart=0.0, precision="single")
    models, profiles = {}, {}
    for name in PATHS:
        models[name], counts, steps, rate, eager_rate = drive_path(
            name, fused_conv, graph, p)
        row = {"gan": "k1", "gz": "k1_bf16", "vae": "k2"}[name]
        rows[row]["launches"] = counts[PATHS[name][2]]
        rows[row]["graph_replays"] = steps["replayed_steps"]
        if name == "gz":
            rows["k3"]["launches"] = counts["launches_probe"]
        prof = profiles[name] = {"member_steps_per_s": rate,
                                 "member_steps_per_s_eager": eager_rate}
        for kind_, step in (
                ("eager", make_online_step(p, models[name], "AR1", 1)),
                ("graphed", graph.GraphedStep(p, models[name], "AR1", 1))):
            carry = init_run_carry(p, np.stack([core.default_initial_q(
                p, rng=np.random.default_rng(j)).numpy()
                for j in range(MEMBERS)]), 0, models[name], device=DEV)
            for _ in range(3 * p.taveints):  # both graphs captured
                carry = step(carry)
            before = read_counts(fused_conv, graph)[1]
            prof[kind_] = step_profile(step, carry)
            after = read_counts(fused_conv, graph)[1]
            replays = after["replayed_steps"] - before["replayed_steps"]
            want = 2 * PROFILE_STEPS + QUEUED_STEPS \
                if kind_ == "graphed" else 0
            chain = prof[kind_]["traced_launches_per_step"].get(
                PATHS[name][3], 0)
            if replays != want or after["captured_steps"] != \
                    before["captured_steps"] or chain != PATHS[name][4]:
                raise AssertionError(
                    f"path {name}, {kind_} step profile: {replays} steps "
                    f"replayed, expected {want}; graph counts {after}; "
                    f"{chain} launches of {PATHS[name][3]} a step, "
                    f"expected {PATHS[name][4]}")
            q = prof[kind_]
            log(f"step profile, path {name}, {kind_}, {MEMBERS} x {NX}^2 on "
                f"{smi}: {q['step_ms']:.4f} ms a step by the host clock; "
                f"the host enqueues a step in {q['host_ms_per_step']:.4f} "
                f"ms, the card runs it in {q['queued_step_ms']} ms; "
                f"{q['traced_kernels_per_step']:.1f} kernels a step, "
                f"{chain:g} of {PATHS[name][3]}; traced window busy "
                f"{100 * q['traced_busy_share']:.1f}% of its span")
    for name in PATHS:
        profiles[name]["graphed_vs_eager_replays"] = graphed_vs_eager(
            name, models[name], p, graph)
    profiles["gan"]["drivers_replays"] = drivers_on_card(models["gan"], p,
                                                          graph)
    for name in PATHS:
        profiles[name]["card_vs_reference"] = card_vs_reference(
            name, models[name], p, fused_conv)
    # 9. every closure
    t0 = time.perf_counter()
    zoo_readings = every_closure(fused_conv, graph, p, smi)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"step_profile": profiles}))
    print(json.dumps({"every_closure": zoo_readings, "card": smi}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
