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
   - K3: exactly. K3, its plain version and the packing take about as
     long as a launch, so each is timed as the median of 7 windows of 200
     calls, with the spread (min, max) beside it;
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
   held across it captures anew;
10. the scoring path (see REDUCED for its cut), each part with the counts
   set to 0 just before it and read just after:
   - generate_subgrid_forcing at the eddy configuration at 256^2, Nc =
     (64,), Operator2 and Operator5, 2 snapshots of 1,000 steps, its DNS
     steps replayed from a captured graph, twice (host seconds and
     member-steps/s of each run); then 20 steps and one snapshot in
     float64 on the card and on the CPU: q, u, v, psi to 1e-9 of max|ref|
     and S to 1e-9 of its advection term's max (S is the difference of two
     such terms), each plus one float32 rounding;
   - test_offline at M = 1000 on those snapshots of eddy_gan_64 (K1) and
     of r4_eddy_vae_64_op1_s0 with "packed" (K2): the offline program
     hands the kernel 256 draws x 2 snapshots = 512 images a call, 4
     calls; at that batch each kernel against its plain version (rtol 2e-4
     / atol 2e-5*max) and by the per-layer check on a random field through
     the same Conv_0, and on the offline input itself against the cuDNN
     chain, which sums in its order (there the last layer is a
     cancellation that float32 resolves to about 1e-4 of its max, so the
     plain version, float64 and the per-layer check are readings); each
     kernel timed at that batch;
   - the GZ's predict (r4_eddy_gz_64_op1_s0, path 2's settings, run in
     float32 offline: 2 K1 calls) on the snapshots and on them scaled to
     the model's input scale: its mean and variance nets against the same
     nets in float64 on the CPU, the card no further than twice the CPU or
     2e-5 of max|ref| (the mean net's output is a cancellation);
   - eddy_gan_64 through run_ensemble (10 x 64^2, dt 14400 s, AR1,
     diagnostics on) and a 256^2 reference run for the same 83 days,
     coarse-grained by coarsegrain_reference_dataset (Operator2, 64):
     diagnostic_differences, distrib_score and spectral_score, readings;
   - entry(): 20 calls of its step (K1-bf16 once a step; its variant "dx"
     never probes, so K3 does not launch), q finite, K1-bf16 by the
     per-layer check on the step's chain input, K3 against its plain
     version.
11. training (see REDUCED_11 and training_path);
12. the experiment pipeline through its own functions (exp/pipeline.py,
   exp/cli.py, ml/multifit.py) into the ignored build/phase12/, each stage
   with the counts set to 0 just before it and read just after (see
   REDUCED_12): run_forcing_datasets (12 runs of the 256^2 DNS to 64^2,
   Operator1 and Operator2, advanced together), train_parameterizations
   (GZ, GAN, VAE at the committed widths, 1 epoch), fit_gan_ensemble and
   fit_vae_ensemble (K = 2, the VAE with "packed": K2 in its evaluation),
   each replica bitwise equal to its own fit on the card, run_reference and
   run_parameterized of the phase's GAN at 10 x 64^2 (K1 under the graph)
   with compute_online_metrics, run_forecasting and run_forecast_truth,
   train_ANN, and each CLI subcommand once through cli.main.
13. the rest of orchestration into the ignored build/phase13/ (see
   orchestration_path):
   - the port's native loader (g++ builds native/fastloader.cpp) over a
     store of 4,096 samples of phase 11's training snapshots (256 MiB),
     200 epochs at batch 64 under a watchdog: every epoch yields every
     sample once and each batch's rows are the store's; GB/s delivered;
   - fit_streaming of the AndrewCNN at the committed widths (MSE), its
     first 3 batches of 8 on the card in float32 against the CPU in
     float64 (numpy loader in both) to relative 1e-5; then 2 epochs at
     batch 64 from the native loader through two pinned buffers: ms a
     batch, the host's wait for the loader, a traced window's busy share,
     and the device-resident fit at the same batch beside it;
   - the trained net's offline evaluation, BN-folded, at 512 x 64^2 (one
     K1 call), its output against K1's plain version on the same Conv_0
     output, and K1 there by the per-layer check, with its times;
   - a 1-rank NCCL group: run_ensemble of eddy_gan_64 at 10 x 64^2, AR1,
     diagnostics on, with ensemble_sharding, bitwise the unsharded run,
     K1 launched and the graph replaying (one rank gathers nothing, so
     no collective runs on this path); the cost of drawing the whole
     ensemble's noise against a quarter's; dryrun_multichip(1) on the
     card (its GAN steps in float64 and float32 run NCCL collectives, its
     ensemble launches K1) and dryrun_multichip(4, device="cpu");
   - measure_throughput of the main path's graphed step beside
     bench_torch.py's and phase 4's readings; trace() naming K1's kernel;
     debug_nans over graphed steps (which then run eagerly) and naming the
     first operator of a step fed one NaN; first_bad_step -1 on a clean
     200-step GAN run.
It prints a JSON line of the step profiles, one of phase 9's readings, one
each of phases 10, 11, 12 and 13, one of kernel measurements, then the
nvidia-smi line, and last {"ok": true, "device": {...}}. In the kernel
line, launches is the path's wrapper calls in phase 4's graphed runs, and
graph_replays the replayed steps there, each of which launches the kernel
as an eager step does; max_abs_err is max|kernel - plain| at the path's
shapes; for K1-bf16, which sums in its own order, the largest per-layer
max|K1-bf16 - float64|, and its extra library_grouped_ms times cuDNN with
groups=2. K1 and K2 carry layer_ms, their device ms a layer, and K2 its bf16
reading. Each row's "phase10" holds the kernel at phase 10's shapes (K1 and
K2 at the offline batch, K1-bf16 at entry()'s one member, K3 at the probe's
shape): its batch, its launches in phase 10's runs, max|kernel - plain|,
its ms, its plain version's and the library's, and its bound. K1's and
K2's rows also hold "phase11" and "phase12", their launches there, and
K1's "phase13": its launches on phase 13's driven parts (the offline
evaluation, the sharded ensemble, the utilities), and at the offline batch
its errors, ms, plain, library and bound.

Run from the repository root: python3 chip_smoke.py
Where CUDA is not available it exits with code 1 and prints no result.
"""
import concurrent.futures
import json
import pathlib
import subprocess
import sys
import threading
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
# phase 10: the scoring path. The DNS is the pipeline's eddy configuration at
# 256^2 (exp/pipeline.py:43-57), cut from 300 runs of 87,600 steps to one run
# of DNS_SNAPS snapshots of 1,000 steps; the offline ensemble is the
# published M = 1000; the forcing is held card against CPU in float64 after
# CHECK_STEPS steps; entry()'s step runs ENTRY_CALLS times
DNS_NX, DNS_SNAPS, OFFLINE_M, CHECK_STEPS, ENTRY_CALLS = 256, 2, 1000, 20, 20
REDUCED = ("one DNS run of 2,000 steps at 256^2 (2 snapshots of 1,000 "
           "steps), where the pipeline runs 300 of 87,600 "
           "(exp/pipeline.py:43-57); the online runs for the same 83.3 "
           "days; widths, grids and M = 1000 as published")
# phase 11: training. The data are the eddy DNS at DNS_NX^2, TRAIN_MEMBERS
# + TEST_MEMBERS members of TRAIN_SNAPS snapshots every TRAIN_SNAP_STEPS
# steps, coarse-grained by Operator1 to NX^2 (640 training and 128 test
# snapshots); each closure trains TRAIN_EPOCHS epochs at batch TRAIN_BATCH
# into TRAIN_DIR and is scored offline at M = TRAIN_M; the card-vs-CPU
# step takes CARD_CPU_BATCH snapshots of developed flow, after
# SPINUP_SNAPS x 1,000 DNS steps; a training step is timed over
# TIMED_STEPS batches and traced over TRACED_STEPS
TRAIN_MEMBERS, TEST_MEMBERS, TRAIN_SNAPS, TRAIN_SNAP_STEPS = 40, 8, 16, 100
TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_M, CARD_CPU_BATCH = 2, 64, 64, 8
SPINUP_SNAPS = 40  # of 1,000 DNS steps before the card-vs-CPU snapshots
TIMED_STEPS, TRACED_STEPS = 10, 5
TRAIN_DIR = ROOT / "build" / "phase11_models"
REDUCED_11 = ("the training data from 48 members of a 1,600-step 256^2 DNS "
              "(640 + 128 snapshots every 100 steps from the initial "
              "condition), where the pipeline takes 300 runs of 87,600 "
              "steps (exp/pipeline.py:43-57); 2 epochs, where the paper "
              "trains 200 (50 for the regression nets); M = 64 offline; "
              "widths, grids, batch 64 and the rates as published")
# phase 12: the experiment pipeline (exp/pipeline.py, exp/cli.py,
# ml/multifit.py) through its own functions into PIPE_DIR: PIPE_RUNS forcing
# runs of the DNS_NX^2 eddy DNS (every split of train_parameterizations
# non-empty at its default fractions), PIPE_SNAPS snapshots every
# PIPE_SNAP_STEPS steps, coarse-grained to NX^2 by Operator1 and Operator2;
# PIPE_EPOCHS epochs of each closure at batch TRAIN_BATCH, the committed
# widths; replicas PIPE_KEYS; references and the online GAN for
# PIPE_ONLINE_STEPS steps at NX^2 (PIPE_SNAPS_ONLINE snapshots of
# ANDREW_1000_STEPS); forecasts of PIPE_DAYS days, PIPE_FORECAST_ENS members
PIPE_DIR = ROOT / "build" / "phase12"
PIPE_RUNS, PIPE_SNAPS, PIPE_SNAP_STEPS, PIPE_EPOCHS = 12, 4, 250, 1
PIPE_KEYS = (0, 1)
PIPE_ONLINE_STEPS, PIPE_SNAPS_ONLINE = 500, 2
PIPE_DAYS, PIPE_FORECAST_ENS = 5.0, 15
OFFLINE_KEYS = ("L2_mean", "L2_total", "L2_residual")
REDUCED_12 = ("12 forcing runs of 1,000 DNS steps at 256^2, where the "
              "pipeline runs 300 of 87,600 (exp/pipeline.py:43-57); 1 "
              "epoch and 1 realization, where it trains 200 (50) and 5; "
              "references and online runs of 500 steps at 64^2 (the 256^2 "
              "reference with 2 members), where they run 20 years; "
              "forecasts of 2 ICs and 5 days, where they run 15 and 90; "
              "widths, grids, batch 64 and M = 1000 as published")
# phase 13: the rest of orchestration into PHASE13_DIR. The loader's store
# holds STORE_SAMPLES samples of phase 11's training snapshots (q and S
# normalised, NHWC, 2 levels each: 64 KiB a sample, and its index), 256 MiB;
# the stress runs STRESS_EPOCHS epochs at batch TRAIN_BATCH under a
# STRESS_LIMIT s watchdog; fit_streaming trains the AndrewCNN at the
# committed widths STREAM_EPOCHS epochs at batch TRAIN_BATCH (a window of
# TRACED_STEPS batches traced), held against the CPU in float64 over
# CHECK_BATCHES batches of CARD_CPU_BATCH; the device-resident fit runs over
# FIT_SAMPLES samples; the sharded GAN ensemble MESH_STEPS steps; NAN_STEPS
# graphed steps under debug_nans
PHASE13_DIR = ROOT / "build" / "phase13"
STORE_SAMPLES, STRESS_EPOCHS, STRESS_LIMIT = 4096, 200, 120.0
STREAM_EPOCHS, FIT_SAMPLES, CHECK_BATCHES = 2, 1024, 3
MESH_STEPS, MESH_SNAP, NAN_STEPS = 60, 30, 8
COUNTS = ("launches", "launches_bf16", "launches_packed", "launches_probe")
K1_KERNEL = "conv_fma_kernel"  # in the name of K1's float32 kernel
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


def median_ms(fn, calls=200, windows=7):
    """(median, min, max) over `windows` windows of fn()'s mean ms by CUDA
    events over `calls` calls each: a kernel that takes about as long as
    its launch, timed without one window's noise deciding."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / calls)
    ms.sort()
    return ms[len(ms) // 2], ms[0], ms[-1]


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
    return packed, x, k1_vs_plain(fused_conv, packed, x, f"B={B}, {H}^2")


def k1_vs_plain(fused_conv, packed, x, what, out=None):
    """K1's output on x (`out`, else a launch here) against its plain
    version, within rtol 2e-4 / atol 2e-5 max|plain|; returns max|err|."""
    if out is None:
        out = fused_conv.fused_cnn_forward(x, packed)
    torch.cuda.synchronize()
    ref = fused_conv.fused_cnn_forward_plain(x, packed)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    ref64 = float64_chain(x, packed)
    ok = torch.allclose(out, ref, rtol=2e-4, atol=2e-5 * scale)
    log(f"K1 vs plain at {what}: max|err| {err:.3e}, max|ref| "
        f"{scale:.3e}, within rtol 2e-4 / atol 2e-5*max: {ok}; against "
        f"float64 of the same weights: K1 "
        f"{float((out.double() - ref64).abs().max()):.3e}, plain "
        f"{float((ref.double() - ref64).abs().max()):.3e}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{what}")
    return err


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
    # K3 takes about as long as a launch: each time is the median of 7
    # windows of 200 calls, with its spread (min, max)
    k3 = {k: median_ms(fn) for k, fn in (
        ("ms", lambda: fused_conv.bitcast_pack_words(probe)),
        ("plain_ms", lambda: fused_conv.bitcast_pack_words_plain(probe)),
        ("library_ms", lambda: library_pack(probe)))}
    rows["k3"] = kernel_row(
        "k3_pack_bf16_pairs", "bitcast_probe.cu", 308, 0.0, k3["ms"][0],
        k3["plain_ms"][0], 0.0, 2 * probe.numel() + 4 * probe.numel() // 2,
        PEAK_BF16_FLOPS, k3["library_ms"][0])
    for k, (_, lo, hi) in k3.items():
        rows["k3"][k.replace("ms", "ms_spread")] = [lo, hi]

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


def set_counts():
    """Every launch count and the graph's step counts to 0."""
    from pyqg_generative_torch.utils import profiling
    profiling.reset_counters()


def read_counts():
    """({launch count: value}, {graph step count: value}), read from the
    port's counters."""
    from pyqg_generative_torch.utils import profiling
    c = profiling.counters()
    return ({k: c.get(f"fused_conv.{k}", 0) for k in COUNTS},
            {k: c.get(f"graph.{k}", 0) for k in GRAPH_COUNTS})


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
    set_counts()
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
    counts, steps = read_counts()
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

    set_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = eager_ensemble(p.replace(tmax=STEPS * p.dt), closure, MEMBERS,
                           SNAP_EVERY, n_snaps)
    eager_wall = time.perf_counter() - t0
    eager_counts, eager_steps = read_counts()
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
            f"{len(gstep.graphs.graphs)} graphs")
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

        set_counts()
        ds = run()
        counts, steps = read_counts()
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


def f32_kernel_times(fused_conv, name, packed, x):
    """ms of a float32 chain kernel (K1 or K2) on x, of its plain version and
    of the dense cuDNN chain, and its bound, as phase 3's rows have them."""
    forward, plain = {
        "K1": (fused_conv.fused_cnn_forward,
               fused_conv.fused_cnn_forward_plain),
        "K2": (fused_conv.packed_cnn_forward,
               fused_conv.packed_cnn_forward_plain)}[name]
    B, H, W, _ = x.shape
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    row = kernel_row(
        name, "", 0, None, cuda_ms(lambda: forward(x, packed), 5, 1),
        cuda_ms(lambda: plain(x, packed), 5, 1),
        fused_conv.flops_per_member(packed.meta, H, W) * B,
        4 * (x.numel() + B * H * W * packed.meta[-1][2]
             + packed.wflat.numel() + packed.bflat.numel()),
        PEAK_FP32_FLOPS,
        cuda_ms(lambda: library_chain(x_nchw, packed.weights,
                                      packed.biases), 5, 1))
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}


def with_run_dim(ds):
    """The snapshots of one run on the (run, time, lev, y, x) dims that
    test_offline reads."""
    from pyqg_generative_torch.utils import xrlite as xr
    out = xr.Dataset(attrs=dict(ds.attrs))
    for k in ("q_forcing_advection", "q", "u", "v", "psi"):
        out[k] = ds[k].expand_dims("run")
    return out


def forcing_on_card(fused_conv, graph, smi):
    """Phase 10, part 1: generate_subgrid_forcing at the eddy configuration
    at 256^2, Nc = (64,), Operator2 and Operator5, DNS_SNAPS snapshots of
    1,000 steps, its DNS steps graphed; then card against CPU in float64
    after CHECK_STEPS steps and one snapshot. Returns (the datasets, the
    readings)."""
    from pyqg_generative_torch.qg.operators import advect
    from pyqg_generative_torch.qg.params import ANDREW_1000_STEPS, \
        EDDY_PARAMS
    from pyqg_generative_torch.sim import generate_subgrid_forcing
    p = EDDY_PARAMS.with_nx(DNS_NX).replace(
        tmax=DNS_SNAPS * ANDREW_1000_STEPS)
    steps = DNS_SNAPS * int(round(ANDREW_1000_STEPS / p.dt))
    readings = {}
    for run in ("first", "second"):
        set_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_subgrid_forcing([NX], p, ANDREW_1000_STEPS,
                                       ("Operator2", "Operator5"),
                                       device=DEV)
        seconds = time.perf_counter() - t0
        counts, gsteps = read_counts()
        if any(counts.values()) or gsteps["eager_steps"] + \
                gsteps["replayed_steps"] != steps or \
                gsteps["replayed_steps"] < steps - 10:
            raise AssertionError(f"forcing DNS: launch counts {counts}, "
                                 f"graph counts {gsteps} for {steps} steps")
        readings[run] = {"seconds": seconds,
                         "dns_member_steps_per_s": steps / seconds,
                         "graph_counts": gsteps}
        log(f"phase 10, forcing data ({run} run): a {DNS_NX}^2 DNS of "
            f"{steps} steps (dt {p.dt:g} s, {p.precision}), Operator2 and "
            f"Operator5 to {NX}^2 every 1,000 steps: {seconds:.3f} s by the "
            f"host clock, {steps / seconds:.1f} member-steps/s, graph "
            f"counts {gsteps} on {smi}")
    if sorted(out) != [f"Operator{o}-{NX}-dealias" for o in (2, 5)]:
        raise AssertionError(f"forcing datasets {sorted(out)}")
    for combo, ds in out.items():
        for k in ("q_forcing_advection", "q", "u", "v", "psi"):
            v = ds[k].values
            if v.shape != (DNS_SNAPS, 2, NX, NX) or not np.isfinite(v).all():
                raise AssertionError(f"{combo} {k}: shape {v.shape} or "
                                     "not finite")
        if not np.abs(ds["q_forcing_advection"].values).max() > 0:
            raise AssertionError(f"{combo}: no subgrid forcing")

    # card against CPU in float64. The datasets hold float32, so each value
    # may also differ by the one rounding of its float64 value to float32.
    # The forcing S = adv(q̄) - op(adv(q)) is a difference of two advection
    # terms, and its float64 rounding is of their size: near the initial
    # condition, and for the sharp Operator5 at any time where the DNS's
    # field is resolved at 64^2, S is that rounding alone. So S is held to
    # 1e-9 of the coarse advection term's max, the rest to 1e-9 of their own
    pd = p.replace(precision="double", tmax=CHECK_STEPS * p.dt)
    card, cpu = (generate_subgrid_forcing([NX], pd, CHECK_STEPS * p.dt,
                                          device=d) for d in (DEV, "cpu"))
    worst = {}
    for combo, ref in cpu.items():
        terms = advect(*(torch.as_tensor(ref[k].values, dtype=torch.float64)
                         for k in ("q", "u", "v")), "3/2-rule")
        for k in ("q_forcing_advection", "q", "u", "v", "psi"):
            a, b = card[combo][k].values, ref[k].values
            scale = float(terms.abs().max()) if k == "q_forcing_advection" \
                else float(np.abs(b).max())
            worst[f"{combo} {k}"] = float(np.abs(a - b).max()) / scale
            np.testing.assert_allclose(a, b, rtol=2.4e-7, atol=1e-9 * scale,
                                       err_msg=f"{combo} {k}")
        worst[f"{combo} S / max|S|"] = float(np.abs(
            card[combo]["q_forcing_advection"].values
            - ref["q_forcing_advection"].values).max()) / float(
            np.abs(ref["q_forcing_advection"].values).max())
    readings["card_vs_cpu_double"] = worst
    log(f"phase 10, forcing data card vs CPU in float64 after {CHECK_STEPS} "
        "steps, max|diff| / scale (bound 1e-9 plus one float32 rounding; "
        "S against its advection term): " + "; ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    return out, readings


def offline_on_card(fused_conv, graph, forcing, rows, smi):
    """Phase 10, part 2: test_offline of eddy_gan_64 (K1) and of
    r4_eddy_vae_64_op1_s0 with "packed" (K2) on the Operator2 snapshots at
    M = OFFLINE_M; the kernel at the batch the offline program gives it,
    against its plain version and by the per-layer check, and timed; the
    GZ's predict, card against CPU."""
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.models.base import extract
    from pyqg_generative_torch.models.common import OFFLINE_PIXELS
    from pyqg_generative_torch.utils import xrlite as xr
    ds = with_run_dim(forcing[f"Operator2-{NX}-dealias"])
    B = DNS_SNAPS
    m = min(OFFLINE_M, OFFLINE_PIXELS // (B * NX * NX))
    want_calls = -(-OFFLINE_M // m)
    readings = {}
    for name, row, kernel in (("gan", "k1", "K1"), ("vae", "k2", "K2")):
        folder, kw, count, *_ = PATHS[name]
        model = load_model(folder, device=DEV, **kw)
        set_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.test_offline(ds, ensemble_size=OFFLINE_M)
        seconds = time.perf_counter() - t0
        counts = read_counts()[0]
        want = {c: 0 for c in COUNTS}
        want[count] = want_calls
        if counts != want:
            raise AssertionError(f"offline {name}: launch counts {counts}, "
                                 f"expected {want}")
        for k in ("R2_mean", "R2_total", "L2_mean", "L2_total", "var_ratio",
                  "PSD_gen", "Eflux_gen", "PDF_gen0", "spatial_skill"):
            if not np.isfinite(out[k].values).all():
                raise AssertionError(f"offline {name}: {k} not finite")
        # the kernel at the offline batch: the chain input of the first
        # chunk of m draws
        chain = model._offline_cnn()
        x = torch.as_tensor(model.x_scale.normalize(extract(ds, "q")),
                            device=DEV)
        z = torch.randn((m, B, NX, NX, 2), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(4))
        act = chain.first_layer(torch.cat(
            [x.expand((m,) + tuple(x.shape)), z], -1).flatten(0, 1))
        forward, plain = {
            "K1": (fused_conv.fused_cnn_forward,
                   fused_conv.fused_cnn_forward_plain),
            "K2": (fused_conv.packed_cnn_forward,
                   fused_conv.packed_cnn_forward_plain)}[kernel]
        packed = chain.packed
        # at the offline batch, on a random field through the same Conv_0:
        # the kernel against its plain version at the float32 bar, and the
        # per-layer check
        rand = chain.first_layer(torch.randn(
            (m * B, NX, NX, 4), device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(14)))
        y, ref = forward(rand, packed), plain(rand, packed)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        if not torch.allclose(y, ref, rtol=2e-4,
                              atol=2e-5 * float(ref.abs().max())):
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version at the offline batch {m * B}")
        check_layers(fused_conv, kernel, packed, rand,
                     f"random field at the offline batch {m * B} x {NX}^2")
        # on the offline input itself the last layer's 2 channels are a
        # cancellation that float32 resolves to about 1e-4 of their max,
        # whatever the order: the kernel is held against the cuDNN chain,
        # which sums in its order, at the float32 bar; its plain version,
        # float64 and the per-layer check are readings
        y, lib = forward(act, packed), fused_conv.fused_cnn_forward_plain(
            act, packed)
        own, ref64 = plain(act, packed), float64_chain(act, packed)
        torch.cuda.synchronize()
        scale = float(lib.abs().max())
        if not torch.allclose(y, lib, rtol=2e-4, atol=2e-5 * scale):
            raise AssertionError(f"{kernel} disagrees with the cuDNN chain "
                                 f"on the offline input, batch {m * B}")
        layers = fused_conv.layer_check(act, packed, forward)["layers"]
        log(f"{kernel} on the offline input at batch {m * B}: max|{kernel} "
            f"- cuDNN chain| {float((y - lib).abs().max()):.3e} of max "
            f"{scale:.3e}; readings: max|{kernel} - its plain version| "
            f"{float((y - own).abs().max()):.3e}, against float64 "
            f"{kernel} {float((y.double() - ref64).abs().max()):.3e}, "
            f"plain {float((own.double() - ref64).abs().max()):.3e}; per "
            "layer against float64 (relative RMS) " + ", ".join(
                f"{r:.2e}" for r, _, _ in layers))
        timing = f32_kernel_times(fused_conv, kernel, packed, act)
        rows[row]["phase10"] = {"batch": m * B, "launches": counts[count],
                                "max_abs_err": err, **timing}
        readings[name] = {
            "seconds": seconds, "launches": counts[count], "batch": m * B,
            **{k: out[k].values.tolist() for k in (
                "R2_mean", "R2_total", "L2_mean", "L2_total", "var_ratio")}}
        log(f"phase 10, test_offline of {name} at M = {OFFLINE_M} on "
            f"{B} snapshots: {seconds:.3f} s; {kernel} launched "
            f"{counts[count]} times at a batch of {m * B} x {NX}^2, "
            f"max|{kernel} - plain| {err:.3e} on a random field; "
            f"{kernel} {timing['ms']:.3f} ms, plain {timing['plain_ms']:.3f}"
            f", cuDNN chain {timing['library_ms']:.3f}, bound "
            f"{timing['bound_ms']:.3f} ms on {smi}; R2_mean "
            f"{readings[name]['R2_mean']}, L2_total "
            f"{readings[name]['L2_total']}")

    # the GZ's predict, card against CPU. The mean net's output is a small
    # difference of large activations, which float32 resolves to 1e-3 of
    # its max on these snapshots (far below the nets' training amplitude)
    # and to 4e-5 at that amplitude, in either summation order. So each of
    # its two nets is held against the same net in float64 (the unfolded
    # module on the CPU): the card no further from it than twice the CPU,
    # or than 2e-5 of max|ref|; card against CPU is a reading. The
    # snapshots are read as they are and scaled, each level, to the
    # model's input scale (x_scale).
    import copy
    folder, kw, *_ = PATHS["gz"]
    card_model = load_model(folder, device=DEV, **kw)
    cpu_model = load_model(folder, device="cpu", **kw)
    nets64 = [copy.deepcopy(n).double() for n in (cpu_model.net_mean,
                                                  cpu_model.net_var)]
    q = ds["q"].values
    std = q.std(axis=(0, 1, 3, 4), keepdims=True)
    developed = xr.Dataset()
    developed["q"] = xr.DataArray(
        (q / std * card_model.x_scale.std.reshape(1, 1, 2, 1, 1)).astype(
            np.float32), ds["q"].dims)
    for what, data in (("snapshots", ds), ("developed", developed)):
        set_counts()
        card = card_model.predict(data)
        counts = read_counts()[0]
        if counts["launches"] != 2 or counts["launches_bf16"]:
            raise AssertionError(f"GZ offline: launch counts {counts}, "
                                 "expected 2 float32 K1 calls")
        cpu = cpu_model.predict(data)
        x = torch.as_tensor(cpu_model.x_scale.normalize(extract(data, "q")),
                            dtype=torch.float64)
        with torch.no_grad():
            ref64 = [n(x).numpy() for n in nets64]
        ref64 = [np.moveaxis(cpu_model.y_scale.denormalize(ref64[0]), -1, 1),
                 np.moveaxis(cpu_model.y_scale.denormalize_var(ref64[1]),
                             -1, 1)]
        gz = {}
        for k, r in zip(("q_forcing_advection_mean",
                         "q_forcing_advection_var"), ref64):
            a = card[k].values.reshape(r.shape)
            b = cpu[k].values.reshape(r.shape)
            scale = float(np.abs(r).max())
            gz[k] = {"card_vs_float64": float(np.abs(a - r).max()) / scale,
                     "cpu_vs_float64": float(np.abs(b - r).max()) / scale,
                     "card_vs_cpu": float(np.abs(a - b).max()) / scale}
            if not gz[k]["card_vs_float64"] <= max(
                    2 * gz[k]["cpu_vs_float64"], 2e-5):
                raise AssertionError(f"GZ predict {k} on the {what}: {gz[k]}")
        readings[f"gz_predict_{what}"] = gz
        log(f"phase 10, GZ predict on the {what}, max|diff| / max|float64|: "
            + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.3e}" for n, v in
                                             d.items())
                        for k, d in gz.items()))
    return readings


def online_scores(fused_conv, graph, smi):
    """Phase 10, part 3: eddy_gan_64 through run_ensemble (MEMBERS x 64^2,
    dt 14400 s, AR1, diagnostics on) and a 256^2 reference run with
    diagnostics for the same model time, coarse-grained by Operator2 to
    64^2, and the paper's comparison of the two."""
    from pyqg_generative_torch.eval import comparison
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg.params import ANDREW_1000_STEPS, \
        EDDY_PARAMS
    from pyqg_generative_torch.sim import run_ensemble, run_simulation
    tmax = DNS_SNAPS * ANDREW_1000_STEPS
    p = EDDY_PARAMS.with_nx(NX).replace(tavestart=0.0, tmax=tmax)
    model = load_model(FOLDER, device=DEV)
    set_counts()
    t0 = time.perf_counter()
    ens = run_ensemble(p, {"self": model, "sampling": "AR1", "nsteps": 1},
                       n_ens=MEMBERS, sampling_freq=ANDREW_1000_STEPS,
                       device=DEV)
    ens_s = time.perf_counter() - t0
    counts, gsteps = read_counts()
    if counts["launches"] != gsteps["eager_steps"] + \
            gsteps["captured_steps"] or gsteps["replayed_steps"] < 1:
        raise AssertionError(f"online GAN: launch counts {counts}, graph "
                             f"counts {gsteps}")
    t0 = time.perf_counter()
    ref = run_simulation(EDDY_PARAMS.with_nx(DNS_NX).replace(
        tavestart=0.0, tmax=tmax), sampling_freq=ANDREW_1000_STEPS,
        device=DEV)
    ref_s = time.perf_counter() - t0
    coarse = comparison.coarsegrain_reference_dataset(ref, NX, "Operator2",
                                                      device=DEV)
    norm, _, _ = comparison.diagnostic_differences(ens, coarse, T=DNS_SNAPS)
    distrib = comparison.distrib_score(norm)
    spectral = comparison.spectral_score(norm)
    if not (np.isfinite(distrib) and np.isfinite(spectral)
            and np.isfinite(list(norm.values())).all()):
        raise AssertionError(f"online scores not finite: {norm}")
    log(f"phase 10, online: {MEMBERS} x {NX}^2 GAN members for "
        f"{tmax / 86400:.1f} days in {ens_s:.3f} s, the {DNS_NX}^2 "
        f"reference in {ref_s:.3f} s; distrib_score {distrib:.4f}, "
        f"spectral_score {spectral:.4f} (readings of a short run from the "
        f"initial condition, not the paper's scores) on {smi}")
    return {"ensemble_seconds": ens_s, "reference_seconds": ref_s,
            "graph_counts": gsteps, "launches": counts["launches"],
            "distrib_score": distrib, "spectral_score": spectral,
            "normalized_differences": norm}


def entry_on_card(fused_conv, graph, rows, smi):
    """Phase 10, part 4: entry()'s step ENTRY_CALLS times on the card (K1 in
    bf16 a step; its GAN's variant "dx" resolves without the probe, as the
    twin's does, so K3 does not launch); K1-bf16 by the per-layer check on
    the step's chain input after them; K3's words against its plain
    version."""
    from pyqg_generative_torch.entry import entry, untrained_gan
    from pyqg_generative_torch.models.common import nhwc_from_lev
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.qg.params import QGParams
    set_counts()
    fn, (state, sstate) = entry()
    for _ in range(ENTRY_CALLS):
        state, sstate = fn(state, sstate)
    torch.cuda.synchronize()
    counts = read_counts()[0]
    want = {c: 0 for c in COUNTS}
    want["launches_bf16"] = ENTRY_CALLS
    if counts != want or not torch.isfinite(state.qh).all():
        raise AssertionError(f"entry(): launch counts {counts}, expected "
                             f"{want}, or q not finite")
    p = QGParams(nx=64, dt=14400.0, precision="single")
    model = untrained_gan(64, device=DEV)
    chain = model._online_cnn()
    x = nhwc_from_lev(core.fields(state.qh, p).q) / model._x_std
    act = chain.first_layer(torch.cat([x, sstate.noise[None]], -1))
    err = check_layers(fused_conv, "K1-bf16", chain.packed, act,
                       f"entry()'s chain input after {ENTRY_CALLS} steps")
    packed = chain.packed
    B, H, W, _ = act.shape
    act_bf = act.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    w_bf = [w.to(torch.bfloat16) for w in packed.weights]
    b_bf = [b.to(torch.bfloat16) for b in packed.biases]
    row = kernel_row(
        "", "", 0, err,
        cuda_ms(lambda: fused_conv.fused_cnn_forward(act, packed)),
        cuda_ms(lambda: fused_conv.fused_cnn_forward_plain(act, packed)),
        fused_conv.flops_per_member(packed.meta, H, W) * B,
        4 * (act.numel() + B * H * W * packed.meta[-1][2]
             + packed.bflat.numel()) + 2 * packed.wflat.numel(),
        PEAK_BF16_FLOPS, cuda_ms(lambda: library_chain(act_bf, w_bf, b_bf)))
    rows["k1_bf16"]["phase10"] = {
        "batch": B, "launches": counts["launches_bf16"],
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}}
    probe = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.bfloat16,
                         device=DEV)[:, None].expand(4, 128).contiguous()
    if not torch.equal(fused_conv.bitcast_pack_words(probe),
                       fused_conv.bitcast_pack_words_plain(probe)):
        raise AssertionError("K3 disagrees with its plain version")
    rows["k3"]["phase10"] = {
        "batch": 1, "launches": counts["launches_probe"],
        **{k: rows["k3"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}}
    log(f"phase 10, entry(): {ENTRY_CALLS} steps, launch counts {counts}; "
        f"K1-bf16 at 1 x 64^2 {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f}, cuDNN bf16 {row['library_ms']:.4f}, bound "
        f"{row['bound_ms']:.6f} ms on {smi}; K3 equals its plain version")
    return {"calls": ENTRY_CALLS, "launch_counts": counts,
            "k1_bf16_worst_layer_err": err}


def scoring_path(fused_conv, graph, rows, smi):
    """Phase 10 (see the module's docstring). Returns its readings."""
    t0 = time.perf_counter()
    forcing, readings = forcing_on_card(fused_conv, graph, smi)
    out = {"forcing": readings,
           "offline": offline_on_card(fused_conv, graph, forcing, rows, smi),
           "online": online_scores(fused_conv, graph, smi),
           "entry": entry_on_card(fused_conv, graph, rows, smi),
           "reduced": REDUCED}
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# phase 11: training
# --------------------------------------------------------------------------

def training_data(fused_conv, graph, smi):
    """Phase 11's forcing data: the eddy DNS at DNS_NX^2 for TRAIN_MEMBERS +
    TEST_MEMBERS members advanced together, coarse-grained by Operator1 to
    NX^2 every TRAIN_SNAP_STEPS steps, TRAIN_SNAPS snapshots a member; the
    first TRAIN_MEMBERS members train, the rest test. Returns (ds_train,
    ds_test, readings)."""
    from pyqg_generative_torch.qg.params import EDDY_PARAMS
    from pyqg_generative_torch.sim import generate_subgrid_forcing_batch
    from pyqg_generative_torch.utils import xrlite as xr
    p = EDDY_PARAMS.with_nx(DNS_NX)
    p = p.replace(tmax=TRAIN_SNAPS * TRAIN_SNAP_STEPS * p.dt)
    members = TRAIN_MEMBERS + TEST_MEMBERS
    set_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = generate_subgrid_forcing_batch(
        [NX], p, TRAIN_SNAP_STEPS * p.dt, ("Operator1",),
        keys=range(100, 100 + members), device=DEV)
    seconds = time.perf_counter() - t0
    counts, gsteps = read_counts()
    steps = TRAIN_SNAPS * TRAIN_SNAP_STEPS
    if any(counts.values()) or gsteps["eager_steps"] + \
            gsteps["replayed_steps"] != steps:
        raise AssertionError(f"phase 11 DNS: launch counts {counts}, graph "
                             f"counts {gsteps} for {steps} steps")

    def stack(part):
        ds = xr.Dataset()
        for k in ("q", "q_forcing_advection", "u", "v", "psi"):
            v = np.stack([r[f"Operator1-{NX}-dealias"][k].values
                          for r in part])
            if v.shape != (len(part), TRAIN_SNAPS, 2, NX, NX) or \
                    not np.isfinite(v).all():
                raise AssertionError(f"phase 11 data {k}: {v.shape}")
            ds[k] = xr.DataArray(v, ("run", "time", "lev", "y", "x"))
        return ds

    ds_train, ds_test = stack(runs[:TRAIN_MEMBERS]), stack(
        runs[TRAIN_MEMBERS:])
    readings = {"members": members, "snapshots_train": TRAIN_MEMBERS
                * TRAIN_SNAPS, "snapshots_test": TEST_MEMBERS * TRAIN_SNAPS,
                "dns_steps": steps, "seconds": seconds,
                "dns_member_steps_per_s": members * steps / seconds,
                "graph_counts": gsteps}
    log(f"phase 11, data: a {DNS_NX}^2 eddy DNS of {members} members x "
        f"{steps} steps (dt {p.dt:g} s), Operator1 to {NX}^2 every "
        f"{TRAIN_SNAP_STEPS} steps: {readings['snapshots_train']} training "
        f"and {readings['snapshots_test']} test snapshots in {seconds:.3f} "
        f"s, {readings['dns_member_steps_per_s']:.1f} member-steps/s on "
        f"{smi}")
    return ds_train, ds_test, readings


def closures_to_train():
    """Phase 11's closures at the committed models' widths (128/64/32x5,
    nx 64) and the paper's rates: name -> (make(folder) -> model, fit's
    arguments, load_model's overrides, its stats files)."""
    from pyqg_generative_torch.models import ANNModel, CGANRegression, \
        CVAEBottleneck, CVAERegression, MeanVarModel, OLSModel
    common = dict(num_epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH)
    gen = dict(common, learning_rate=2e-4, nruns=2, key=0)
    reg = dict(common, learning_rate=1e-3)
    return {
        "gan": (lambda f: CGANRegression(nx=NX, folder=f, device=DEV),
                dict(gen, retain_every=1), {}, ("stats.npz",)),
        "vae": (lambda f: CVAERegression(folder=f, online_variant="packed",
                                         device=DEV),
                gen, {"online_variant": "packed"}, ("stats.npz",)),
        "bottleneck": (lambda f: CVAEBottleneck(nx=NX, folder=f,
                                                device=DEV),
                       dict(gen, num_epochs_regression=TRAIN_EPOCHS), {},
                       ("stats.npz",)),
        "gz": (lambda f: MeanVarModel(folder=f, device=DEV), reg, {},
               ("stats_mean.npz", "stats_var.npz")),
        "ols": (lambda f: OLSModel(folder=f, device=DEV), reg, {},
                ("stats.npz",)),
        "ann": (lambda f: ANNModel(folder=f, device=DEV),
                dict(num_epochs=TRAIN_EPOCHS, learning_rate=1e-3), {},
                ("stats.npz",)),
    }


def train_every_closure(fused_conv, graph, ds_train, ds_test, smi):
    """Phase 11, part 1: each closure trained by fit for TRAIN_EPOCHS
    epochs at batch TRAIN_BATCH into TRAIN_DIR/<name>, its logged losses
    finite (the GAN's and the VAEs' with L2_total_test), its folder loaded
    by load_model and scored by test_offline at M = TRAIN_M on the test
    snapshots. Returns the readings and the trained GAN."""
    import shutil

    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.utils import xrlite as xr
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    readings, gan = {}, None
    for name, (make, fit_kw, overrides, stats) in \
            closures_to_train().items():
        folder = str(TRAIN_DIR / name)
        set_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = make(folder)
        model.fit(ds_train, ds_test, **fit_kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()[0]
        logged = {}
        for f in stats:
            log_ds = xr.Dataset.from_npz(f"{folder}/{f}")
            for k in log_ds.keys():
                v = np.asarray(log_ds[k].values, float)
                if not np.isfinite(v).all():
                    raise AssertionError(f"phase 11 {name}: {f} {k} {v}")
                logged[f"{f[:-4]}/{k}"] = v.tolist()
        if name in ("gan", "vae", "bottleneck") and \
                "stats/L2_total_test" not in logged:
            raise AssertionError(f"phase 11 {name}: no L2_total_test")
        t0 = time.perf_counter()
        loaded = load_model(folder, device=DEV, **overrides)
        offline = loaded.test_offline(ds_test, TRAIN_M)
        torch.cuda.synchronize()
        offline_s = time.perf_counter() - t0
        launches = read_counts()[0]
        scores = {k: float(np.mean(offline[k].values))
                  for k in ("L2_mean", "L2_total", "L2_residual")}
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"phase 11 {name}: test_offline {scores}")
        readings[name] = {"fit_seconds": fit_s, "launches_in_fit": counts,
                          "launches": launches,
                          "log": logged, "test_offline_seconds": offline_s,
                          "test_offline": scores}
        log(f"phase 11, {name}: fit {TRAIN_EPOCHS} epochs at batch "
            f"{TRAIN_BATCH} in {fit_s:.2f} s (launches {counts}); "
            "last epoch " + ", ".join(f"{k} {v[-1]:.4g}" for k, v in
                                      logged.items() if "loss" in k
                                      or "L2_total" in k)
            + f"; test_offline at M = {TRAIN_M} in {offline_s:.2f} s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
            + f" on {smi}")
        if name == "gan":
            gan = model
    return readings, gan


def _term_scales(ref: dict) -> dict:
    """The scale each gradient tensor of a float64 step is measured at: its
    RMS, and for a bias the larger of its RMS and its layer's weight
    gradient's. A bias's gradient is a sum of per-pixel terms of the size
    of its weight gradient's; where a later train-mode BatchNorm subtracts
    the channel's shift again (the ReLU between passing the channel almost
    everywhere over the batch), the sum cancels, to its terms' rounding
    where the ReLU passes every pixel."""
    out = {}
    for k, g in ref.items():
        w = ref.get(k[:-len("bias")] + "weight") if k.endswith(".bias") \
            else None
        rms = float((g ** 2).mean().sqrt())
        out[k] = rms if w is None else max(rms, float((w ** 2).mean().sqrt()))
    return out


def developed_snapshots():
    """CARD_CPU_BATCH snapshots of developed eddy flow at NX^2: a DNS_NX^2
    eddy DNS run for SPINUP_SNAPS + CARD_CPU_BATCH snapshots of 1,000
    steps (5.5 years at dt 3,600 s, past the configuration's 5-year
    spin-up), coarse-grained by Operator1; the last CARD_CPU_BATCH."""
    from pyqg_generative_torch.qg.params import ANDREW_1000_STEPS, \
        EDDY_PARAMS
    from pyqg_generative_torch.sim import generate_subgrid_forcing
    n = SPINUP_SNAPS + CARD_CPU_BATCH
    p = EDDY_PARAMS.with_nx(DNS_NX).replace(tmax=n * ANDREW_1000_STEPS)
    ds = generate_subgrid_forcing([NX], p, ANDREW_1000_STEPS, ("Operator1",),
                                  device=DEV)[f"Operator1-{NX}-dealias"]
    return ds.isel(time=np.arange(SPINUP_SNAPS, n))


def card_vs_cpu_steps(smi):
    """Phase 11, part 2: from the committed r4_eddy_gan_64_op1_s0 (G and D)
    and r4_eddy_vae_64_op1_s0 (encoder and decoder), one batch step of
    CARD_CPU_BATCH snapshots of developed flow (`developed_snapshots`,
    normalised by the model's own scalers, as it was trained) on the card
    in float32 against the CPU in float64, on the same draws: the GAN's
    critic and generator at i = 0, the VAE's loss; each loss to relative
    1e-5, each gradient tensor to relative RMS 1e-4 of float64. Where
    float32 itself cannot get there, the card is held as the scoring path
    holds its cancellations (PR 10): a bias is measured at the scale of
    its per-pixel terms (`_term_scales`), and a tensor that the CPU's own
    float32 step misses by more than half the bar is held no further from
    float64 than twice the CPU's float32."""
    from pyqg_generative_torch.device import exact_fp32_training
    from pyqg_generative_torch.ml.train import named_params
    from pyqg_generative_torch.models import base, load_model
    from pyqg_generative_torch.models import cgan_regression as gan
    from pyqg_generative_torch.models import cvae_regression as vae
    t0 = time.perf_counter()
    ds = developed_snapshots()
    log(f"phase 11, {CARD_CPU_BATCH} snapshots of developed flow after "
        f"{SPINUP_SNAPS},000 DNS steps at {DNS_NX}^2 in "
        f"{time.perf_counter() - t0:.2f} s")
    q, f = (base.extract(ds, k) for k in ("q", "q_forcing_advection"))
    shape = q.shape
    g = torch.Generator().manual_seed(11)
    z = [torch.randn(shape, generator=g, dtype=torch.float64)
         for _ in range(2)]
    eps_gp = torch.rand((CARD_CPU_BATCH, 1, 1, 1), generator=g,
                        dtype=torch.float64)
    eps_vae = torch.randn(shape, generator=g, dtype=torch.float64)
    runs = {"card": (DEV, torch.float32), "cpu32": ("cpu", torch.float32),
            "cpu64": ("cpu", torch.float64)}
    readings = {}
    for name in ("gan", "vae"):
        out = {}
        for run, (dev, dtype) in runs.items():
            folder = str(MODELS / {"gan": "r4_eddy_gan_64_op1_s0",
                                   "vae": "r4_eddy_vae_64_op1_s0"}[name])
            m = load_model(folder, device=dev)
            x, y = m.x_scale.normalize(q), m.y_scale.normalize(f)

            def t(a):
                return torch.as_tensor(a, device=dev).to(dtype)
            batch = (t(x), t(y), torch.zeros_like(t(x)))
            if name == "gan":
                m.G.to(dtype)
                m.D.to(dtype)
                txG, txD = gan.gan_optimizers(2e-4, 2, 10)
                opt = {"G": txG.init(named_params(m.G)),
                       "D": txD.init(named_params(m.D))}
                grads = {}
                metrics = gan.make_gan_batch_step(m, txG, txD)(
                    opt, batch, 0, (t(z[0]), t(z[1]), t(eps_gp),
                                    torch.tensor(True, device=dev)), grads)
                flat = {f"{k}.{n}": v for k in ("D", "G")
                        for n, v in grads[k].items()}
            else:
                m.encoder.to(dtype)
                m.decoder.to(dtype)
                params = vae.vae_params(m)
                with exact_fp32_training():
                    loss, metrics = vae.make_vae_loss(m)(
                        *batch, t(eps_vae), True)
                    flat = dict(zip(params, torch.autograd.grad(
                        loss, list(params.values()))))
            out[run] = ({k: float(v.detach()) for k, v in metrics.items()},
                        {k: v.detach().double().cpu()
                         for k, v in flat.items()})
        (mc, gc), (_, g32), (mr, gr) = out["card"], out["cpu32"], \
            out["cpu64"]
        loss_err = {k: abs(mc[k] / mr[k] - 1) for k in mr if mr[k] != 0}
        scales = _term_scales(gr)
        grad_err, cpu_err, bars = {}, {}, {}
        for k, g_ in gr.items():
            grad_err[k] = float(((gc[k] - g_) ** 2).mean().sqrt()) / scales[k]
            cpu_err[k] = float(((g32[k] - g_) ** 2).mean().sqrt()) / scales[k]
            bars[k] = max(1e-4, 2 * cpu_err[k])
        failed = {k: (grad_err[k], bars[k]) for k in gr
                  if not grad_err[k] <= bars[k]}
        worst = max(grad_err, key=lambda k: grad_err[k] / bars[k])
        at_terms = [k for k, g_ in gr.items()
                    if scales[k] > float((g_ ** 2).mean().sqrt())]
        ill = {k: (grad_err[k], cpu_err[k]) for k in gr if bars[k] > 1e-4}
        readings[name] = {"losses_card": mc, "losses_cpu": mr,
                          "loss_rel_err": loss_err,
                          "grad_rel_rms": grad_err,
                          "grad_rel_rms_cpu_float32": cpu_err,
                          "grad_worst": worst, "biases_at_terms": at_terms,
                          "float32_ill_conditioned": ill}
        log(f"phase 11, {name} batch step of {CARD_CPU_BATCH} from the "
            "committed weights, card float32 vs CPU float64: loss relative "
            "errors " + ", ".join(f"{k} {v:.3e}" for k, v in loss_err.items())
            + f"; gradients' relative RMS up to {grad_err[worst]:.3e} "
            f"({worst}, bar {bars[worst]:.1e}); {len(at_terms)} of "
            f"{len(gr)} biases measured at their terms' scale ("
            + ", ".join(at_terms) + "); where the CPU's float32 misses "
            "float64 by more than 5e-5 (card, CPU float32): "
            + (", ".join(f"{k} {a:.3e} {b:.3e}" for k, (a, b) in
                         ill.items()) or "none") + f"; on {smi}")
        bad = {k: v for k, v in loss_err.items() if not v <= 1e-5}
        if bad or failed:
            raise AssertionError(f"phase 11 {name} card vs CPU: losses "
                                 f"{bad}, gradients {failed}")
    return readings


def resume_on_card(fused_conv, graph, ds_train, ds_test, smi):
    """Phase 11, part 3: a GAN at full width trained for 2 epochs, and one
    interrupted after its epoch-1 checkpoint and resumed by a fresh model
    on its folder, end with bitwise-equal G and D. Returns the readings
    with the launch counts of the three runs."""
    from pyqg_generative_torch.ml import train
    from pyqg_generative_torch.models import CGANRegression
    kw = dict(num_epochs=2, batch_size=TRAIN_BATCH, nruns=2, key=1,
              checkpoint_every=1, verbose=False)
    set_counts()
    t0 = time.perf_counter()
    ref = CGANRegression(nx=NX, folder=str(TRAIN_DIR / "resume_ref"),
                         device=DEV)
    ref.fit(ds_train, ds_test, **kw)
    folder = str(TRAIN_DIR / "resume_cut")
    orig = train.TrainCheckpointer.maybe_save

    def crashing(self, epoch, *a, **k):
        orig(self, epoch, *a, **k)
        if self.path and epoch >= 1:
            raise KeyboardInterrupt

    train.TrainCheckpointer.maybe_save = crashing
    try:
        CGANRegression(nx=NX, folder=folder, device=DEV).fit(
            ds_train, ds_test, **kw)
        raise AssertionError("phase 11 resume: the run was not cut")
    except KeyboardInterrupt:
        pass
    finally:
        train.TrainCheckpointer.maybe_save = orig
    resumed = CGANRegression(nx=NX, folder=folder, device=DEV)
    resumed.fit(ds_train, ds_test, **kw)
    torch.cuda.synchronize()
    differ = {}
    for net in ("G", "D"):
        a = getattr(ref, net).state_dict()
        b = getattr(resumed, net).state_dict()
        for k in a:
            if not torch.equal(a[k], b[k]):
                differ[f"{net}.{k}"] = float((a[k] - b[k]).abs().max())
    seconds = time.perf_counter() - t0
    launches = read_counts()[0]
    log(f"phase 11, GAN resume on the card (2 epochs against 1 + 1): "
        f"{'bitwise equal' if not differ else differ} in {seconds:.1f} s "
        f"on {smi}")
    if differ:
        raise AssertionError(f"phase 11 resume differs: {differ}")
    return {"bitwise_equal": True, "seconds": seconds,
            "launches": launches}


def stable_epoch_on_card(fused_conv, graph, gan, ds_test, smi):
    """Phase 11, part 4: select_stable_epoch over the trained GAN's two
    banked generators, each a short graphed run_ensemble (2 members, dt
    7200 s, from a test snapshot): K1 launches, each candidate's run
    captures its own graphs and replays them, and weights_generation grows
    once a candidate and once for the chosen one."""
    from pyqg_generative_torch import sim
    from pyqg_generative_torch.qg.params import QGParams
    runs = []
    orig = sim.run_ensemble

    def counted(*a, **k):
        before = read_counts()
        generation = gan.weights_generation
        ds = orig(*a, **k)
        after = read_counts()
        runs.append({"weights_generation": generation,
                     **{c: after[1][c] - before[1][c] for c in GRAPH_COUNTS},
                     "launches": after[0]["launches"]
                     - before[0]["launches"]})
        return ds

    set_counts()
    generation = gan.weights_generation
    sim.run_ensemble = counted
    try:
        t0 = time.perf_counter()
        best, results = gan.select_stable_epoch(
            pyqg_params=QGParams(nx=NX, dt=7200.0, precision="single"),
            q_init=ds_test["q"].values[0, -1], years=0.01, n_ens=2,
            verbose=True)
        seconds = time.perf_counter() - t0
    finally:
        sim.run_ensemble = orig
    counts = read_counts()
    ok = (best in (1, 2) and sorted(results) == [1, 2] and len(runs) == 2
          and all(r["captured_steps"] > 0 and r["replayed_steps"] > 0
                  and r["launches"] > 0 for r in runs)
          and runs[0]["weights_generation"] < runs[1]["weights_generation"]
          and gan.weights_generation == generation + 3
          and (TRAIN_DIR / "gan" / "G_stable.msgpack").exists())
    log(f"phase 11, select_stable_epoch on the card: best epoch {best}, "
        f"(std, spectrum error) {results}, runs {runs}, counts {counts}, "
        f"weights_generation {generation} -> {gan.weights_generation}, "
        f"{seconds:.2f} s on {smi}")
    if not ok:
        raise AssertionError("phase 11 select_stable_epoch: see above")
    return {"best_epoch": best, "results": {str(k): v for k, v in
                                            results.items()},
            "runs": runs, "launch_counts": counts[0], "seconds": seconds}


def _train_step_profile(step):
    """ms a batch step by the host clock over TIMED_STEPS steps (the card
    synchronised at both ends), and a window of TRACED_STEPS steps traced
    by torch.profiler: the device's busy share (the union of the kernel
    intervals over the window's span), device ms and kernels a step."""
    for j in range(5):
        step(j)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(TIMED_STEPS):
        step(j)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for j in range(TRACED_STEPS):
                step(j)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    if not kernels:
        raise AssertionError("the profiler saw no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy = _union_us(spans)
    return {"ms_per_batch": ms,
            "traced_busy_share": busy / (spans[-1][1] - spans[0][0]),
            "traced_device_ms_per_batch": busy / TRACED_STEPS / 1e3,
            "traced_kernels_per_batch": len(kernels) / TRACED_STEPS}


def training_step_readings(ds_train, smi):
    """Phase 11, part 5: the time of a batch step at batch TRAIN_BATCH of
    the GAN (averaged over i = 0..4: one generator update in five), the
    VAE and the GZ's mean net, on the trained models, and the card's busy
    share in traced steps."""
    from pyqg_generative_torch.device import exact_fp32_training
    from pyqg_generative_torch.ml import train
    from pyqg_generative_torch.models import base, common, load_model
    from pyqg_generative_torch.models import cgan_regression as gan
    from pyqg_generative_torch.models import cvae_regression as vae
    X, Y = base.prepare_PV_data(ds_train, ds_train)[:2]
    x = torch.as_tensor(X[:TRAIN_BATCH], device=DEV)
    y = torch.as_tensor(Y[:TRAIN_BATCH], device=DEV)
    batch = (x, y, torch.zeros_like(x))
    g = torch.Generator(device=DEV).manual_seed(0)
    readings = {}

    m = load_model(str(TRAIN_DIR / "gan"), device=DEV)
    txG, txD = gan.gan_optimizers(2e-4, 2, 10)
    opt = {"G": txG.init(train.named_params(m.G)),
           "D": txD.init(train.named_params(m.D))}
    gstep = gan.make_gan_batch_step(m, txG, txD)
    readings["gan"] = _train_step_profile(
        lambda j: gstep(opt, batch, j % 5, gan.gan_draws(g, x, 2)))

    m = load_model(str(TRAIN_DIR / "vae"), device=DEV)
    tx = vae.vae_optimizer(2e-4, 2, 10)
    vparams = vae.vae_params(m)
    vopt = tx.init(vparams)
    vstep = vae.make_vae_step(m, tx)

    def vae_step(j):
        scalars = tx.scalars(next(iter(vparams.values())), vopt["count"])
        vstep(vopt, batch, vae.vae_eps(g, m, x), scalars)
        vopt["count"] += 1
    readings["vae"] = _train_step_profile(vae_step)

    m = load_model(str(TRAIN_DIR / "gz"), device=DEV)
    tx = train.multistep_adam(1e-3, 2, 10)
    ropt = tx.init(train.named_params(m.net_mean))
    rstep = train.make_train_step(common.mse_loss_fn(m.net_mean),
                                  m.net_mean, tx)

    def gz(j):
        with exact_fp32_training():
            rstep(ropt, (x, y))
    readings["gz_mean_net"] = _train_step_profile(gz)
    for name, r in readings.items():
        log(f"phase 11, {name} training step at batch {TRAIN_BATCH} x "
            f"{NX}^2: {r['ms_per_batch']:.3f} ms a batch by the host clock; "
            f"traced: the card busy {100 * r['traced_busy_share']:.1f}% of "
            f"the window, {r['traced_device_ms_per_batch']:.3f} device ms "
            f"and {r['traced_kernels_per_batch']:.0f} kernels a batch on "
            f"{smi}")
    return readings


def training_path(fused_conv, graph, rows, smi):
    """Phase 11: the training slice on the card (see the docstring), each
    part with the counts set to 0 just before it and read just after; K1's
    and K2's launches over the phase go into their kernel rows. Returns
    (readings, the training snapshots)."""
    t0 = time.perf_counter()
    ds_train, ds_test, data = training_data(fused_conv, graph, smi)
    closures, gan = train_every_closure(fused_conv, graph, ds_train,
                                        ds_test, smi)
    out = {"data": data, "closures": closures, "reduced": REDUCED_11,
           "card_vs_cpu": card_vs_cpu_steps(smi),
           "resume": resume_on_card(fused_conv, graph, ds_train, ds_test,
                                    smi),
           "stable_epoch": stable_epoch_on_card(fused_conv, graph, gan,
                                                ds_test, smi)}
    set_counts()
    out["step_readings"] = training_step_readings(ds_train, smi)
    parts = [c["launches"] for c in closures.values()] + [
        out["resume"]["launches"], out["stable_epoch"]["launch_counts"],
        read_counts()[0]]
    launches = {k: sum(p[k] for p in parts) for k in COUNTS}
    if not launches["launches"] or not launches["launches_packed"]:
        raise AssertionError(f"phase 11 launched no K1 or no K2: {launches}")
    rows["k1"]["phase11"] = {"launches": launches["launches"]}
    rows["k2"]["phase11"] = {"launches": launches["launches_packed"]}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out, ds_train


# --------------------------------------------------------------------------
# phase 12: the experiment pipeline
# --------------------------------------------------------------------------

def pipeline_stage(name, fn, fused_conv, graph, stages, smi):
    """One stage of phase 12, with the counts set to 0 just before it and
    read just after: its seconds, launch counts and graph counts go into
    stages[name]. Returns fn()'s result."""
    set_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, gsteps = read_counts()
    stages[name] = {"seconds": seconds, "launches": counts,
                    "graph_counts": gsteps}
    log(f"phase 12, {name}: {seconds:.2f} s, launches {counts}, graph "
        f"counts {gsteps} on {smi}")
    return out


def _finite_files(pattern, n, what, keys=("q",)):
    """The n .npz files of `pattern`, each holding `keys`, finite."""
    import glob

    from pyqg_generative_torch.utils import xrlite as xr
    files = sorted(glob.glob(pattern))
    if len(files) != n:
        raise AssertionError(f"phase 12 {what}: {len(files)} files of "
                             f"{pattern}, expected {n}")
    for f in files:
        ds = xr.Dataset.from_npz(f)
        for k in keys:
            if not np.isfinite(ds[k].values).all():
                raise AssertionError(f"phase 12 {what}: {f} {k} not finite")
    return files


def _same_modules(a, b, names, files, what):
    """Two trained models' modules bitwise equal, and their files byte for
    byte; raises with the first that differs."""
    for name in names:
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        for k in sa:
            if not torch.equal(sa[k], sb[k]):
                raise AssertionError(f"phase 12 {what}: {name}.{k} differs "
                                     f"by {float((sa[k] - sb[k]).abs().max())}")
    for f in files:
        if (pathlib.Path(a.folder) / f).read_bytes() != \
                (pathlib.Path(b.folder) / f).read_bytes():
            raise AssertionError(f"phase 12 {what}: {f} differs")


def multifit_on_card(base, splits):
    """fit_gan_ensemble and fit_vae_ensemble (the VAE with "packed": its
    offline evaluation through K2), K = 2 at the committed widths, each
    replica bitwise equal to its own fit with the same key on the card."""
    from pyqg_generative_torch.ml.multifit import fit_gan_ensemble, \
        fit_vae_ensemble
    from pyqg_generative_torch.models import CGANRegression, CVAERegression
    ds_train, ds_val = splits
    fit_kw = dict(num_epochs=PIPE_EPOCHS, batch_size=TRAIN_BATCH, nruns=2,
                  verbose=False)
    kinds = {
        "gan": (lambda f: CGANRegression(nx=NX, folder=f, device=DEV),
                fit_gan_ensemble, dict(retain_every=1), ("G", "D"),
                ("G.msgpack", "G_opt.msgpack", "stats.npz",
                 "epoch_bank/G_1.msgpack")),
        "vae": (lambda f: CVAERegression(folder=f, online_variant="packed",
                                         device=DEV),
                fit_vae_ensemble, {}, ("encoder", "decoder"),
                ("decoder.msgpack", "decoder_opt.msgpack", "stats.npz")),
    }
    out = {}
    for kind, (make, fit, extra, modules, files) in kinds.items():
        singles = []
        for key in PIPE_KEYS:
            m = make(str(base / f"{kind}_fit{key}"))
            m.fit(ds_train, ds_val, key=key, **fit_kw, **extra)
            singles.append(m)
        replicas = [make(str(base / f"{kind}_replica{key}"))
                    for key in PIPE_KEYS]
        t0 = time.perf_counter()
        fit(replicas, [ds_train] * len(replicas), [ds_val] * len(replicas),
            keys=PIPE_KEYS, **fit_kw, **extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for m, r in zip(singles, replicas):
            _same_modules(m, r, modules, files, f"{kind} replica")
        out[kind] = {"replicas": len(replicas), "bitwise_equal": True,
                     "ensemble_seconds": seconds}
        log(f"phase 12, {kind} ensemble of {len(replicas)} replicas: each "
            f"bitwise equal to its own fit (modules, {', '.join(files)}); "
            f"the ensemble in {seconds:.2f} s")
    return out


def cli_on_card(base, gan, ref_hi, forcing_glob):
    """Every subcommand of the port's CLI once, on the card (its default
    device): outputs present and finite; `parameterized` runs the phase's
    GAN at --model-weight 0.5."""
    from pyqg_generative_torch.exp import cli
    d = base / "cli"
    runs = {
        "reference": (["--nx", str(NX), "--params",
                       json.dumps({"tmax": 20 * 14400.0, "tavestart": 0.0}),
                       "--sampling-freq", str(10 * 14400.0), "--n-ens", "2"],
                      "*.npz", 2),
        "forcing": (["--nx", str(DNS_NX), "--params",
                     json.dumps({"tmax": 40 * 3600.0}), "--sampling-freq",
                     str(20 * 3600.0), "--nc", f"[{NX}]"],
                    "Operator2-*/0.npz", 1),
        "parameterized": (["--nx", str(NX), "--params",
                           json.dumps({"tmax": 40 * 14400.0,
                                       "tavestart": 0.0}),
                           "--sampling-freq", str(20 * 14400.0),
                           "--model-folder", gan, "--n-ens", str(MEMBERS),
                           "--model-weight", "0.5"], "*.npz", MEMBERS),
        "forecast": (["--nx", str(NX), "--params",
                      json.dumps({"tmax": 2 * 86400.0}),
                      "--initial-condition", f"{ref_hi}/0.npz",
                      "--operator", "Operator1", "--model-folder", gan,
                      "--n-ens", "3"], "0.npz", 1),
    }
    for sub, (args, pattern, n) in runs.items():
        cli.main([sub] + args + ["--subfolder", str(d / sub)])
        _finite_files(str(d / sub / pattern), n, f"cli {sub}")
    cli.main(["train", "--model", "OLSModel", "--fit-args",
              json.dumps({"num_epochs": 1, "batch_size": TRAIN_BATCH,
                          "verbose": False}),
              "--model-folder", str(d / "train"), "--train-path",
              forcing_glob, "--ensemble-size", "16"])
    _finite_files(str(d / "train" / "offline_test.npz"), 1, "cli train",
                  OFFLINE_KEYS)
    cli.main(["metrics", "--model-path", str(d / "parameterized" / "*.npz"),
              "--target-path", f"{ref_hi}/.coarse_Operator1_{NX}.npz",
              "--save-file", str(d / "metrics.json"), "--T", "2",
              "--key-name", "cli"])
    with open(d / "metrics.json") as f:
        metrics = json.load(f)
    if metrics.pop("key") != "cli" or not np.isfinite(
            list(metrics.values())).all():
        raise AssertionError(f"phase 12 cli metrics: {metrics}")
    return len(metrics)


def pipeline_path(fused_conv, graph, rows, smi):
    """Phase 12: the pipeline through its own functions into PIPE_DIR (see
    the module's docstring), each stage with the counts set to 0 just
    before it and read just after; K1's and K2's launches over the phase go
    into their kernel rows."""
    import shutil

    from pyqg_generative_torch.exp import pipeline
    from pyqg_generative_torch.qg.params import YEAR, dt_for_nx
    from pyqg_generative_torch.utils import xrlite as xr
    t0 = time.perf_counter()
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    base = str(PIPE_DIR)
    eddy = PIPE_DIR / "eddy"
    stages, out = {}, {"reduced": REDUCED_12}

    def stage(name, fn):
        return pipeline_stage(name, fn, fused_conv, graph, stages, smi)

    dns_dt = dt_for_nx(DNS_NX)
    stage("run_forcing_datasets", lambda: pipeline.run_forcing_datasets(
        base, n_runs=PIPE_RUNS, Nc=(NX,), dns_nx=DNS_NX,
        years=(PIPE_SNAPS * PIPE_SNAP_STEPS + 0.5) * dns_dt / YEAR,
        sampling_freq=PIPE_SNAP_STEPS * dns_dt, batch=PIPE_RUNS,
        device=DEV))
    dns_steps = PIPE_SNAPS * PIPE_SNAP_STEPS
    g = stages["run_forcing_datasets"]["graph_counts"]
    if g["eager_steps"] + g["replayed_steps"] != dns_steps or \
            any(stages["run_forcing_datasets"]["launches"].values()):
        raise AssertionError(f"phase 12 forcing: {stages}")
    for op in ("Operator1", "Operator2"):
        _finite_files(str(eddy / f"{op}-{NX}-dealias" / "*.npz"), PIPE_RUNS,
                      f"forcing {op}", ("q", "q_forcing_advection"))
    forcing_glob = str(eddy / f"Operator1-{NX}-dealias" / "*.npz")

    stage("train_parameterizations", lambda: pipeline.train_parameterizations(
        base, operators=("Operator1",), resolutions=(NX,), realizations=1,
        fit_kw=dict(num_epochs=PIPE_EPOCHS, batch_size=TRAIN_BATCH, nruns=2,
                    verbose=False), device=DEV))
    models = eddy / f"models_Operator1_{NX}"
    for name in ("MeanVarModel-0", "CGANRegression-0", "CVAERegression-0"):
        _finite_files(str(models / name / "offline_test.npz"), 1, name,
                      OFFLINE_KEYS)
    gan = str(models / "CGANRegression-0")

    ds = xr.open_mfdataset(forcing_glob, "run")
    s_train, s_val, _ = pipeline.run_splits(ds["q"].sizes()["run"])
    out["multifit"] = stage("multifit", lambda: multifit_on_card(
        PIPE_DIR / "multifit", (ds.isel(run=s_train), ds.isel(run=s_val))))

    years = (PIPE_ONLINE_STEPS + 0.5) * dt_for_nx(NX) / YEAR
    ref_hi = str(eddy / f"reference_{DNS_NX}")
    stage("run_reference", lambda: (
        pipeline.run_reference(base, resolutions=(NX,), n_ens=MEMBERS,
                               years=years, device=DEV),
        pipeline.run_reference(base, resolutions=(DNS_NX,), n_ens=2,
                               years=years, device=DEV)))
    stage("run_parameterized", lambda: pipeline.run_parameterized(
        base, gan, nx=NX, n_ens=MEMBERS, years=years, device=DEV))
    c, g = (stages["run_parameterized"][k]
            for k in ("launches", "graph_counts"))
    if c["launches"] != g["eager_steps"] + g["captured_steps"] or \
            g["replayed_steps"] < 1:
        raise AssertionError(f"phase 12 run_parameterized: {c}, {g}")
    _finite_files(f"{gan}/online/*.npz", MEMBERS, "online")
    scores = {}
    for key, folder, sub in (("gan", gan, "online"),
                             ("none", str(eddy), f"reference_{NX}")):
        norm = stage(f"compute_online_metrics ({key})",
                     lambda: pipeline.compute_online_metrics(
                         base, folder, f"{ref_hi}/*.npz", "Operator1", NX,
                         subfolder=sub, T=PIPE_SNAPS_ONLINE, device=DEV))
        if not np.isfinite([v for k, v in norm.items() if k != "key"]).all():
            raise AssertionError(f"phase 12 scores ({key}): {norm}")
        scores[key] = {k: norm[k] for k in ("distrib_score",
                                            "spectral_score")}
    # the closure's mark on the flow: both runs start from the same states
    q_gan, q_none = (xr.Dataset.from_npz(f)["q"].values for f in (
        f"{gan}/online/0.npz", str(eddy / f"reference_{NX}" / "0.npz")))
    scores["gan_vs_none_max_dq"] = float(
        np.abs(q_gan - q_none).max() / np.abs(q_none).max())
    out["scores"] = scores
    log(f"phase 12, scores after {PIPE_ONLINE_STEPS} steps (readings; the "
        f"1-epoch GAN's run against the unforced one from the same states, "
        f"max|dq| / max|q| {scores['gan_vs_none_max_dq']:.3e}): {scores}")

    forecast = dict(nx=NX, operator="Operator1", n_ic=2, days=PIPE_DAYS,
                    device=DEV)
    stage("run_forecasting", lambda: pipeline.run_forecasting(
        base, gan, f"{ref_hi}/*.npz", n_ens=PIPE_FORECAST_ENS,
        decorrelations=(0, 12), **forecast))
    stage("run_forecast_truth", lambda: pipeline.run_forecast_truth(
        base, f"{ref_hi}/*.npz", truth_nx=DNS_NX, **forecast))
    for dec in (0, 12):
        for f in _finite_files(str(PIPE_DIR / "forecast" /
                                   f"decorrelation-{dec}h" / "*.npz"), 2,
                               f"forecast {dec}h", ("q", "q_mean", "q_std")):
            if xr.Dataset.from_npz(f).attrs["n_ens_stat"] != \
                    PIPE_FORECAST_ENS - 1:
                raise AssertionError(f"phase 12 forecast {f}: n_ens_stat")
    _finite_files(str(PIPE_DIR / "forecast" / "truth_*.npz"), 2, "truth")

    stage("train_ANN", lambda: pipeline.train_ANN(
        base, configurations=("eddy",), resolutions=(NX,),
        fit_kw=dict(num_epochs=PIPE_EPOCHS, verbose=False), device=DEV))
    _finite_files(str(PIPE_DIR / "ann_model" / f"offline_eddy-{NX}.npz"), 1,
                  "train_ANN", OFFLINE_KEYS)
    out["cli_metrics_keys"] = stage("cli", lambda: cli_on_card(
        PIPE_DIR, gan, ref_hi, forcing_glob))
    g = stages["cli"]["graph_counts"]
    if g["replayed_steps"] < 1:
        raise AssertionError(f"phase 12 cli: no replayed step: {g}")

    launches = {k: sum(st["launches"][k] for st in stages.values())
                for k in COUNTS}
    if not launches["launches"] or not launches["launches_packed"]:
        raise AssertionError(f"phase 12 launched no K1 or no K2: {launches}")
    rows["k1"]["phase12"] = {"launches": launches["launches"]}
    rows["k2"]["phase12"] = {"launches": launches["launches_packed"]}
    out.update(stages=stages, launches=launches,
               seconds=time.perf_counter() - t0)
    return out


# --------------------------------------------------------------------------
# phase 13: the rest of orchestration
# --------------------------------------------------------------------------

def traced_busy(fn):
    """(the card's busy share, kernels) of fn() traced by torch.profiler:
    the union of the kernel intervals over their span."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a window whose kernels the profiler missed
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    if not kernels:
        raise AssertionError("the profiler saw no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    return _union_us(spans) / (spans[-1][1] - spans[0][0]), len(kernels)


class TimedLoader:
    """A FastLoader whose epochs time the host's wait for each batch (the
    wait for a free output buffer, `before_fill`, separately); with `limit`,
    an epoch stops after that many batches."""

    def __init__(self, loader, limit=None):
        self.loader, self.limit = loader, limit
        self.meta = loader.meta
        self.batch_size = loader.batch_size
        self.sample_floats = loader.sample_floats
        self.wait = self.fill_wait = 0.0
        self.batches = 0

    def epoch(self, seed=0, out=None, before_fill=None):
        def fill(k):
            t = time.perf_counter()
            before_fill(k)
            self.fill_wait += time.perf_counter() - t

        it = self.loader.epoch(seed, out, fill if before_fill else None)
        for _ in range(self.limit or 1 << 62):
            t = time.perf_counter()
            batch = next(it, None)
            self.wait += time.perf_counter() - t
            if batch is None:
                return
            self.batches += 1
            yield batch


def sample_store(ds_train):
    """Phase 13's store in PHASE13_DIR: STORE_SAMPLES samples, sample i
    phase 11's training snapshot i mod 640 (q and S normalised, NHWC, 2
    levels each) and its index. Returns (folder, X, Y)."""
    from pyqg_generative_torch.models import base
    from pyqg_generative_torch.utils.native import write_sample_store
    X, Y = base.prepare_PV_data(ds_train, ds_train)[:2]
    take = np.arange(STORE_SAMPLES) % len(X)
    folder = str(PHASE13_DIR / "store")
    write_sample_store(folder, {
        "x": X[take], "y": Y[take],
        "index": np.arange(STORE_SAMPLES, dtype=np.float32)[:, None]})
    return folder, X[take], Y[take]


def loader_stress(folder):
    """STRESS_EPOCHS epochs of the port's native loader at batch
    TRAIN_BATCH into a ring of two buffers, in a thread under a
    STRESS_LIMIT s watchdog: every epoch yields every sample once, each
    batch's rows are the store's (whole rows in the first epoch, every 97th
    float and the last after it). Returns GB/s delivered and the rest."""
    from pyqg_generative_torch.utils.native import FastLoader
    fl = FastLoader(folder, batch_size=TRAIN_BATCH)
    if not fl.native:
        raise AssertionError("phase 13: the loader is not native")
    n, sf = fl.n_samples, fl.sample_floats
    store = np.memmap(f"{folder}/data.bin", np.float32, "r", shape=(n, sf))
    tag = fl.meta["fields"]["index"]["offset"]
    ring = [np.empty((TRAIN_BATCH, sf), np.float32) for _ in range(2)]
    cols = np.r_[0:sf:97, sf - 1]
    box = {}

    def run():
        try:
            t0 = time.perf_counter()
            for e in range(STRESS_EPOCHS):
                seen = np.zeros(n, np.int64)
                for b, _ in enumerate(fl.epoch(seed=e, out=ring)):
                    flat = ring[b % 2]
                    ids = flat[:, tag].astype(np.int64)
                    np.add.at(seen, ids, 1)
                    ref = store[ids] if e == 0 else \
                        store[ids[:, None], cols[None, :]]
                    got = flat if e == 0 else flat[:, cols]
                    if not np.array_equal(got, ref):
                        raise AssertionError(f"epoch {e}, batch {b}: rows "
                                             "differ from the store")
                if not (seen == 1).all():
                    raise AssertionError(f"epoch {e}: {int((seen == 0).sum())}"
                                         " samples missing")
            box["seconds"] = time.perf_counter() - t0
        except BaseException as err:
            box["error"] = err

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(STRESS_LIMIT)
    if t.is_alive():
        raise AssertionError(f"phase 13: the loader's stress run outlasted "
                             f"its {STRESS_LIMIT} s watchdog")
    if "error" in box:
        raise box["error"]
    fl.close()
    gb = STRESS_EPOCHS * n * sf * 4 / 1e9
    return {"epochs": STRESS_EPOCHS, "batch": TRAIN_BATCH,
            "samples": n, "sample_kib": sf * 4 / 1024,
            "every_epoch_complete": True, "seconds": box["seconds"],
            "gb_per_s": gb / box["seconds"]}


def _stream_net(dev, dtype=torch.float32):
    """The AndrewCNN at the committed widths (2 -> 128/64/32x5 -> 2), its
    weights drawn on the CPU from seed 0 (the twin's initializers)."""
    from pyqg_generative_torch.ml.nets import AndrewCNN, init_weights
    net = AndrewCNN(2, 2)
    init_weights(net, torch.Generator().manual_seed(0))
    return net.to(dev, dtype)


def streaming_vs_cpu(X, Y):
    """fit_streaming's first CHECK_BATCHES batches of CARD_CPU_BATCH on the
    card in float32 against the CPU in float64, both reading the numpy
    loader of one small store: each batch's loss to relative 1e-5."""
    from pyqg_generative_torch.device import exact_fp32_training
    from pyqg_generative_torch.ml import train as T
    from pyqg_generative_torch.models.common import mse_loss_fn
    from pyqg_generative_torch.utils.native import FastLoader, \
        write_sample_store
    n = CHECK_BATCHES * CARD_CPU_BATCH
    folder = str(PHASE13_DIR / "check_store")
    write_sample_store(folder, {"x": X[:n], "y": Y[:n]})
    losses = {}
    for name, (dev, dtype) in {"card": (DEV, torch.float32),
                               "cpu64": ("cpu", torch.float64)}.items():
        net = _stream_net(dev, dtype)
        tx = T.multistep_adam(1e-3, 1, CHECK_BATCHES)
        seen = []

        def loss_fn(batch, train, net=net, seen=seen):
            loss, metrics = mse_loss_fn(net)(batch, train)
            seen.append(loss.detach())
            return loss, metrics

        with exact_fp32_training():
            T.fit_streaming(loss_fn, T.TrainingState(
                net, tx.init(T.named_params(net))), tx,
                FastLoader(folder, batch_size=CARD_CPU_BATCH,
                           force_python=True), ("x", "y"), 1, verbose=False)
        losses[name] = [float(v) for v in seen]
    rel = [abs(a / b - 1) for a, b in zip(losses["card"], losses["cpu64"])]
    if len(rel) != CHECK_BATCHES or not max(rel) <= 1e-5:
        raise AssertionError(f"phase 13 fit_streaming card vs CPU: {losses}")
    return {"batches": CHECK_BATCHES, "batch": CARD_CPU_BATCH,
            "losses_card": losses["card"], "losses_cpu64": losses["cpu64"],
            "loss_rel_err": rel}


def streaming_on_card(folder, X, Y, smi):
    """fit_streaming of the committed-width AndrewCNN (MSE) on the store,
    STREAM_EPOCHS epochs at batch TRAIN_BATCH from the native loader into
    two pinned buffers; a window of TRACED_STEPS batches traced; the same
    net's device-resident `fit` over FIT_SAMPLES samples at the same batch.
    Returns (the trained net, readings)."""
    from pyqg_generative_torch.device import exact_fp32_training
    from pyqg_generative_torch.ml import train as T
    from pyqg_generative_torch.models.common import mse_loss_fn
    from pyqg_generative_torch.utils.native import FastLoader
    net = _stream_net(DEV)
    steps = STORE_SAMPLES // TRAIN_BATCH
    tx = T.multistep_adam(1e-3, STREAM_EPOCHS, steps)
    state = T.TrainingState(net, tx.init(T.named_params(net)))
    loader = TimedLoader(FastLoader(folder, batch_size=TRAIN_BATCH))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with exact_fp32_training():
        state, log_ = T.fit_streaming(mse_loss_fn(net), state, tx, loader,
                                      ("x", "y"), STREAM_EPOCHS,
                                      verbose=False)
    wall = time.perf_counter() - t0
    if loader.batches != STREAM_EPOCHS * steps or not np.isfinite(
            log_["loss"]).all():
        raise AssertionError(f"phase 13 fit_streaming: {loader.batches} "
                             f"batches, log {log_}")
    out = {"epochs": STREAM_EPOCHS, "batch": TRAIN_BATCH,
           "batches": loader.batches, "loss": log_["loss"],
           "ms_per_batch": wall / loader.batches * 1e3,
           "loader_wait_ms_per_batch": loader.wait / loader.batches * 1e3,
           "buffer_wait_ms_per_batch":
           loader.fill_wait / loader.batches * 1e3}

    # a traced window: fit_streaming over TRACED_STEPS batches
    probe = _stream_net(DEV)
    ptx = T.multistep_adam(1e-3, 1, steps)
    pstate = T.TrainingState(probe, ptx.init(T.named_params(probe)))

    def window():
        with exact_fp32_training():
            T.fit_streaming(mse_loss_fn(probe), pstate, ptx, TimedLoader(
                FastLoader(folder, batch_size=TRAIN_BATCH),
                limit=TRACED_STEPS), ("x", "y"), 1, verbose=False)
    busy, kernels = traced_busy(window)
    out["traced_busy_share"] = busy
    out["traced_kernels_per_batch"] = kernels / TRACED_STEPS

    # the device-resident fit at the same batch
    resident = _stream_net(DEV)
    rtx = T.multistep_adam(1e-3, 1, FIT_SAMPLES // TRAIN_BATCH)
    rstate = T.TrainingState(resident, rtx.init(T.named_params(resident)))
    data = tuple(torch.as_tensor(a[:FIT_SAMPLES], device=DEV)
                 for a in (X, Y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with exact_fp32_training():
        T.fit(mse_loss_fn(resident), rstate, rtx, data, (), 1, TRAIN_BATCH,
              verbose=False)
    out["resident_fit_ms_per_batch"] = (time.perf_counter() - t0) / (
        FIT_SAMPLES // TRAIN_BATCH) * 1e3
    log(f"phase 13, fit_streaming: {loader.batches} batches of "
        f"{TRAIN_BATCH} x {NX}^2 from the native loader, "
        f"{out['ms_per_batch']:.3f} ms a batch (device-resident fit "
        f"{out['resident_fit_ms_per_batch']:.3f}); the host waits "
        f"{out['loader_wait_ms_per_batch']:.3f} ms a batch for the loader "
        f"({out['buffer_wait_ms_per_batch']:.3f} of it for a free buffer); "
        f"traced: the card busy {100 * out['traced_busy_share']:.1f}%, "
        f"{out['traced_kernels_per_batch']:.0f} kernels a batch; losses "
        f"{log_['loss']} on {smi}")
    return net, out


def trained_net_on_k1(fused_conv, graph, net, X, rows):
    """The fit_streaming net's offline evaluation: BN-folded, on the store's
    first 512 inputs at once (the offline batch at 64^2,
    models/common.py::OFFLINE_PIXELS), Conv_0 in PyTorch and
    Conv_1..Conv_7 through K1; that output against K1's plain version on
    the same Conv_0 output, then K1 there by the per-layer check, and its
    times there. Returns (readings, K1's launches in the evaluation)."""
    from pyqg_generative_torch.ml.nets import fold_batchnorm
    from pyqg_generative_torch.ml.weights import params_to_jax
    folded = fold_batchnorm(params_to_jax(net.state_dict()))
    apply = fused_conv.make_online_cnn(folded, torch.float32, device=DEV)
    x = torch.as_tensor(X[:512], device=DEV)
    set_counts()
    with torch.no_grad():
        y = apply(x)
    torch.cuda.synchronize()
    launches = read_counts()[0]["launches"]
    if launches != 1 or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"phase 13 offline evaluation: {launches} K1 "
                             "launches")
    packed = apply.packed
    with torch.no_grad():
        x = apply.first_layer(x)
    what = f"the fit_streaming net's offline batch, 512 x {NX}^2"
    err = k1_vs_plain(fused_conv, packed, x, what, out=y)
    worst = check_layers(fused_conv, "K1", packed, x, what)
    out = {"batch": 512, "max_abs_err": err, "layer_max_err": worst,
           **f32_kernel_times(fused_conv, "K1", packed, x)}
    rows["k1"]["phase13"] = dict(out)
    return out, launches


def mesh_on_card(fused_conv, graph, smi):
    """A 1-rank NCCL group: run_ensemble of eddy_gan_64 at MEMBERS x NX^2,
    AR1, diagnostics on, with ensemble_sharding, bitwise the unsharded run,
    K1 launched and the graph replaying; the cost of drawing the whole
    ensemble's noise against one member's block; then dryrun_multichip(1)
    on the card and dryrun_multichip(4) on gloo ranks of the CPU, at
    once."""
    import torch.distributed as dist

    from pyqg_generative_torch.entry import dryrun_multichip
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.parallel import ensemble_sharding, make_mesh
    from pyqg_generative_torch.parallel.spawn import free_port
    from pyqg_generative_torch.qg.params import QGParams
    from pyqg_generative_torch.sim import run_ensemble
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        p = QGParams(nx=NX, dt=14400.0, tavestart=0.0, precision="single",
                     tmax=MESH_STEPS * 14400.0)
        closure = {"self": load_model(FOLDER, device=DEV),
                   "sampling": "AR1", "nsteps": 1}
        kw = dict(n_ens=MEMBERS, sampling_freq=MESH_SNAP * p.dt,
                  device=DEV)
        set_counts()
        t0 = time.perf_counter()
        ds = run_ensemble(p, closure, sharding=ensemble_sharding(
            make_mesh()), **kw)
        seconds = time.perf_counter() - t0
        counts, steps = read_counts()
        ref = run_ensemble(p, closure, **kw)
    finally:
        dist.destroy_process_group()
    if counts["launches"] != steps["eager_steps"] + steps["captured_steps"] \
            or steps["replayed_steps"] < 1 or not same_dataset(ds, ref):
        raise AssertionError(f"phase 13 sharded ensemble: counts {counts}, "
                             f"graph {steps}, bitwise "
                             f"{same_dataset(ds, ref)}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    shape = (MEMBERS, NX, NX, 2)
    draw_us = {k: 1e3 * median_ms(lambda s=s: torch.randn(
        s, generator=gen, device=DEV))[0] for k, s in (
        ("whole_ensemble", shape), ("quarter", (MEMBERS // 4,) + shape[1:]))}
    out = {"members": MEMBERS, "steps": MESH_STEPS, "bitwise": True,
           "launches": counts, "graph_counts": steps, "seconds": seconds,
           "noise_draw_us": draw_us}

    def dryrun(n, device):
        t0 = time.perf_counter()
        r = dryrun_multichip(n, device=device)
        return {"seconds": time.perf_counter() - t0, "ok": True,
                "k1_launches": r[0]["ensemble_gan"]["k1_launches"],
                "gan_step": r[0]["gan_step"],
                "gan_step_f32": r[0]["gan_step_f32"],
                "ensemble_gan_err": r[0]["ensemble_gan"]["err"],
                "imported_jax": r[0]["imported_jax"]}

    # the card's rank and the CPU's four run at once, each in processes
    # of its own
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {"1_cuda": pool.submit(dryrun, 1, None),
                "4_cpu": pool.submit(dryrun, 4, "cpu")}
        dry = {k: job.result() for k, job in jobs.items()}
    if dry["1_cuda"]["k1_launches"] < 1:
        raise AssertionError("phase 13: the card's dry run launched no K1")
    out["dryrun"] = dry
    log(f"phase 13, 1-rank NCCL sharded ensemble of eddy_gan_64, {MEMBERS} x "
        f"{NX}^2, {MESH_STEPS} steps: bitwise the unsharded run, launches "
        f"{counts}, graph {steps}; noise draw of the whole ensemble "
        f"{draw_us['whole_ensemble']:.2f} us against a quarter's "
        f"{draw_us['quarter']:.2f} us; dry runs: " + ", ".join(
            f"{k} {v['seconds']:.1f} s" for k, v in dry.items())
        + f" on {smi}")
    return out


def utilities_on_card(fused_conv, graph, phase4_rate, smi):
    """measure_throughput of the main path's graphed step beside
    bench_torch.py's reading; trace() names K1's kernel; debug_nans passes a
    clean eager step (and a GraphedStep steps eagerly under it) and names
    the first operator of a step fed one NaN; first_bad_step gives -1 on a
    clean 200-step GAN run. Returns (readings, K1's launches)."""
    import contextlib
    import io

    import bench_torch
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.qg.params import QGParams
    from pyqg_generative_torch.sim import init_run_carry, make_online_step
    from pyqg_generative_torch.utils.debugging import debug_nans, \
        first_bad_step
    from pyqg_generative_torch.utils.profiling import measure_throughput, \
        trace
    p = QGParams(nx=NX, dt=14400.0, tavestart=0.0, precision="single")
    model = load_model(FOLDER, device=DEV)

    def carry():
        return init_run_carry(p, np.stack([core.default_initial_q(
            p, rng=np.random.default_rng(j)).numpy()
            for j in range(MEMBERS)]), 0, model, device=DEV)

    set_counts()
    thr = measure_throughput(graph.GraphedStep(p, model, "AR1", 1), carry(),
                             n_steps=STEPS, warmup=3 * p.taveints)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_torch.main([])
    bench = json.loads(buf.getvalue().strip().splitlines()[0])
    out = {"measure_throughput": {
        **thr, "member_steps_per_s": MEMBERS * thr["steps_per_s"]},
        "bench_torch_member_steps_per_s": bench["value"],
        "phase4_member_steps_per_s": phase4_rate}

    step = make_online_step(p, model, "AR1", 1)
    c = carry()
    logdir = PHASE13_DIR / "trace"
    with trace(str(logdir)):
        for _ in range(3):
            c = step(c)
        torch.cuda.synchronize()
    names = {e.get("name", "") for e in json.loads(
        (logdir / "trace.json").read_text())["traceEvents"]}
    k1_names = sorted(n for n in names if K1_KERNEL in n)
    if not k1_names:
        raise AssertionError("phase 13: the trace names no K1 kernel")
    out["trace_k1_kernels"] = k1_names[:3]

    before = read_counts()[1]
    gstep, c = graph.GraphedStep(p, model, "AR1", 1), carry()
    with debug_nans():
        for _ in range(NAN_STEPS):
            c = gstep(c)
    after = read_counts()[1]
    if after["captured_steps"] != before["captured_steps"] or \
            after["replayed_steps"] != before["replayed_steps"]:
        raise AssertionError(f"phase 13: a graph under debug_nans {after}")
    bad = carry()
    bad[0].qh[3, 1, 5, 7] = float("nan")
    try:
        with debug_nans():
            step(bad)
        raise AssertionError("phase 13: debug_nans missed a NaN")
    except FloatingPointError as err:
        out["debug_nans_names"] = str(err)
    t0 = time.perf_counter()
    out["first_bad_step_clean"] = first_bad_step(
        p, core.default_initial_q(p, rng=np.random.default_rng(0)),
        max_steps=200, chunk=100,
        parameterization={"self": model, "sampling": "AR1", "nsteps": 1},
        device=DEV)
    out["first_bad_step_seconds"] = time.perf_counter() - t0
    if out["first_bad_step_clean"] != -1:
        raise AssertionError(f"phase 13 first_bad_step: {out}")
    counts = read_counts()[0]
    log(f"phase 13, utilities: measure_throughput of the graphed main "
        f"path {out['measure_throughput']['member_steps_per_s']:.1f} "
        f"member-steps/s, bench_torch.py {bench['value']:.1f}, phase 4 "
        f"{phase4_rate:.1f}; trace names {k1_names[:1]}; debug_nans: "
        f"{out['debug_nans_names']}; first_bad_step -1 in "
        f"{out['first_bad_step_seconds']:.2f} s on {smi}")
    return out, counts["launches"]


def orchestration_path(fused_conv, graph, rows, ds_train, phase4_rate, smi):
    """Phase 13 (see the module's docstring) into PHASE13_DIR: each driven
    part with the counts set to 0 just before it and read just after; K1's
    launches on those parts go into its row's "phase13"."""
    import shutil
    t0 = time.perf_counter()
    parts = {}

    def part(name, fn):
        t = time.perf_counter()
        result = fn()
        parts[name] = time.perf_counter() - t
        return result

    shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    PHASE13_DIR.mkdir(parents=True)
    folder, X, Y = part("store", lambda: sample_store(ds_train))
    out = {"store": {"samples": STORE_SAMPLES,
                     "mib": (PHASE13_DIR / "store" / "data.bin").stat()
                     .st_size / 2 ** 20}}
    out["loader_stress"] = part("loader_stress",
                                lambda: loader_stress(folder))
    log(f"phase 13, loader stress: {STRESS_EPOCHS} epochs of "
        f"{STORE_SAMPLES} samples at batch {TRAIN_BATCH}, each complete: "
        f"{out['loader_stress']['gb_per_s']:.2f} GB/s delivered "
        f"({out['loader_stress']['seconds']:.2f} s)")
    out["fit_streaming_vs_cpu"] = part("fit_streaming_vs_cpu",
                                       lambda: streaming_vs_cpu(X, Y))
    net, out["fit_streaming"] = part(
        "fit_streaming", lambda: streaming_on_card(folder, X, Y, smi))
    out["k1_trained_net"], launches = part(
        "k1_trained_net", lambda: trained_net_on_k1(fused_conv, graph, net,
                                                    X, rows))
    out["mesh"] = part("mesh", lambda: mesh_on_card(fused_conv, graph, smi))
    launches += out["mesh"]["launches"]["launches"]
    out["utilities"], n = part("utilities", lambda: utilities_on_card(
        fused_conv, graph, phase4_rate, smi))
    launches += n
    out["part_seconds"] = parts
    if not out["mesh"]["launches"]["launches"]:
        raise AssertionError("phase 13 launched no K1 on the mesh path")
    rows["k1"]["phase13"]["launches"] = launches
    out["launches_k1"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def _group(name: str) -> str:
    low = name.lower()
    if K1_KERNEL in name:
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
            before = read_counts()[1]
            prof[kind_] = step_profile(step, carry)
            after = read_counts()[1]
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
    # 10. the scoring path
    phase10 = scoring_path(fused_conv, graph, rows, smi)
    log(f"phase 10 took {phase10['seconds']:.1f} s")
    # 11. training
    phase11, ds_train = training_path(fused_conv, graph, rows, smi)
    log(f"phase 11 took {phase11['seconds']:.1f} s")
    # 12. the experiment pipeline
    phase12 = pipeline_path(fused_conv, graph, rows, smi)
    log(f"phase 12 took {phase12['seconds']:.1f} s")
    # 13. the rest of orchestration
    phase13 = orchestration_path(fused_conv, graph, rows, ds_train,
                                 profiles["gan"]["member_steps_per_s"], smi)
    log(f"phase 13 took {phase13['seconds']:.1f} s")
    print(json.dumps({"step_profile": profiles}))
    print(json.dumps({"every_closure": zoo_readings, "card": smi}))
    print(json.dumps({"scoring_path": phase10, "card": smi}))
    print(json.dumps({"training": phase11, "card": smi}))
    print(json.dumps({"pipeline": phase12, "card": smi}))
    print(json.dumps({"phase13": phase13, "card": smi}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
