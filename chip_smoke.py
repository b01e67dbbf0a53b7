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
4. drive each path: every launch count set to 0 just before it and read just
   after; a short warm-up, then a timed run with snapshots. Each path's
   kernel must launch once per closure call (K3 once, when the model
   resolves "dxb"), and no other chain kernel;
5. right after each path's run, where a step of it spends its time: the
   host clock over an untraced window; the device time a step with the
   host's launches hidden (a few steps queued behind a sleeping kernel, then
   run back to back); and a window traced by torch.profiler, with device
   time by kernel group, the host's time by operation, and the union of the
   kernel intervals over the window's device span;
6. after all timings, hold each path on the card (2 members, 10 steps, the
   same frozen noise) to 2e-5*max|q| (see F32_BOUND): a float32 path against
   the same path on the CPU, and the GZ path in float32 against the CPU.
   The bf16 path (GZ): from its carry at step 0 and at step 10, one step
   with K1-bf16 and one with its plain version patched in must hand the
   chain bitwise the same input, and on that input every layer passes the
   per-layer check and the chain equals its layers composed. Its 10-step
   distance from the same path with the plain version patched in, and from
   the CPU, are printed; the latter is held to a coarse bound only (see
   BF16_COARSE).
It prints a JSON line of the step profiles, one of kernel measurements, then
the nvidia-smi line, and last {"ok": true, "device": {...}}. In the kernel
line, max_abs_err is max|kernel - plain| at the path's shapes; for K1-bf16,
which sums in its own order, the largest per-layer max|K1-bf16 - float64|,
and its extra library_grouped_ms times cuDNN with groups=2. K1 and K2 carry
layer_ms, their device ms a layer, and K2 its bf16 reading.

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
# name -> (folder, load_model overrides, the count its chain kernel adds to)
PATHS = {
    "gan": (FOLDER, {}, "launches"),
    "gz": (str(MODELS / "r4_eddy_gz_64_op1_s0"),
           {"inference_dtype": "bfloat16", "online_variant": "dxbpair"},
           "launches_bf16"),
    "vae": (str(MODELS / "r4_eddy_vae_64_op1_s0"),
            {"online_variant": "packed"}, "launches_packed"),
}
# |card - reference| / max|q| after 10 frozen-noise steps: float32 paths
# differ by float32 rounding alone. In bf16 a float32 sum taken in another
# order flips bf16 roundings, and the GZ mean net's output, a small
# difference of large activations, amplifies them to the size of bf16's own
# error; so the bf16 path is held by the per-layer check on its real chain
# inputs, and its distance from the CPU only to BF16_COARSE times the CPU's
# own bf16-versus-float32 distance, which catches a blow-up and no more.
F32_BOUND, BF16_COARSE = 2e-5, 2.0
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


def drive_path(name, fused_conv, p):
    """Phase 4 for one path: counts zeroed, the model loaded, a warm-up and
    a timed run through run_ensemble; returns (model, counts, rate)."""
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.sim import run_ensemble
    folder, kw, count = PATHS[name]
    for c in COUNTS:
        setattr(fused_conv, c, 0)
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
    counts = {c: getattr(fused_conv, c) for c in COUNTS}
    calls = WARMUP_STEPS + STEPS
    want = {c: 0 for c in COUNTS}
    want[count] = calls
    if name == "gz":
        want["launches_probe"] = 1
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} in {calls} "
                             f"closure calls, expected {want}")
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
    log(f"path {name}: {MEMBERS} members x {STEPS} steps at {NX}^2 in "
        f"{wall:.3f} s = {rate:.1f} member-steps/s; launch counts over "
        f"load, warm-up and run {counts}; std(q) "
        f"{ds['q'].values[:, -1].std():.3e}")
    return model, counts, rate


def card_vs_reference(name, model, p, fused_conv):
    """Phase 6 for one path: |card - reference| / max|q| after 10
    frozen-noise steps of 2 members, against F32_BOUND (see there)."""
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    folder, kw, _ = PATHS[name]
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
    groups, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + us
        ms, calls = by_name.get(e.name[:80], (0.0, 0))
        by_name[e.name[:80]] = (ms + us / PROFILE_STEPS / 1e3, calls + 1)
    host = sorted(((e.key, e.self_cpu_time_total)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])
    return {
        "step_ms": step_ms,
        "queued_step_ms": queued_ms,
        "queued_enqueue_ms": enqueue_ms, "queued_sleep_ms": sleep_ms,
        "host_limited_share": None if queued_ms is None
        else 1 - queued_ms / step_ms,
        "traced_step_ms": traced_ms,
        "traced_busy_share": _union_us(spans) / span_us,
        "traced_kernels_per_step": len(kernels) / PROFILE_STEPS,
        "traced_device_ms_per_step": {
            k: v / PROFILE_STEPS / 1e3 for k, v in sorted(
                groups.items(), key=lambda kv: -kv[1])},
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
    from pyqg_generative_torch.sim import init_run_carry, make_online_step

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

    # 4. the three paths, each with 5. its step profile; then 6. each path
    # against the CPU, whose work would disturb the host's timings
    p = QGParams(nx=NX, dt=14400.0, tavestart=0.0, precision="single")
    models, profiles = {}, {}
    for name in PATHS:
        models[name], counts, rate = drive_path(name, fused_conv, p)
        if name == "gan":
            rows["k1"]["launches"] = counts["launches"]
        elif name == "gz":
            rows["k1_bf16"]["launches"] = counts["launches_bf16"]
            rows["k3"]["launches"] = counts["launches_probe"]
        else:
            rows["k2"]["launches"] = counts["launches_packed"]
        step = make_online_step(p, models[name], "AR1", 1, with_diags=True)
        carry = init_run_carry(p, np.stack([core.default_initial_q(
            p, rng=np.random.default_rng(j)).numpy()
            for j in range(MEMBERS)]), 0, models[name], device=DEV)
        for _ in range(2 * p.taveints):
            carry = step(carry)
        prof = profiles[name] = step_profile(step, carry)
        prof["member_steps_per_s"] = rate
        log(f"step profile, path {name}, {MEMBERS} x {NX}^2 on {smi}: "
            f"{prof['step_ms']:.4f} ms a step by the host clock; "
            f"{prof['queued_step_ms']} ms with the launches hidden; traced "
            f"window busy {100 * prof['traced_busy_share']:.1f}% of its "
            f"span")
    for name in PATHS:
        profiles[name]["card_vs_reference"] = card_vs_reference(
            name, models[name], p, fused_conv)
    print(json.dumps({"step_profile": profiles}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
