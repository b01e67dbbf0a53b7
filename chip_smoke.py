"""Smoke run of the PyTorch port (pyqg_generative_torch) on one NVIDIA GPU.

Phases, in order; any failure raises and the exit code is nonzero:
1. report the card (name and power limit from nvidia-smi), torch and CUDA;
2. build kernel K1 (csrc/fused_conv.cu) with nvcc and time the build;
3. hold K1 against its plain PyTorch version: eddy_gan_64's folded weights at
   10 members x 64^2 (the main path's shapes) and random weights at
   3 x 48^2, rtol 2e-4 / atol 2e-5*max|ref|; time K1, the plain version and a
   chain of cuDNN convolutions (the library yardstick), beside K1's bound;
4. drive the main path through `load_model` and `run_ensemble`: eddy_gan_64,
   10 members at 64^2, dt = 14400 s, AR1 white noise, diagnostics on; a
   short warm-up, then a fixed run with snapshots, timed, with K1's launch
   count checked against the number of closure calls;
5. hold the card's main path against the CPU's on a small input (2 members,
   10 steps, the same frozen noise);
6. where a step of the main path spends its time: the host clock over an
   untraced window; the device time a step with the host's launches hidden
   (a few steps queued behind a sleeping kernel, then run back to back); and
   a window traced by torch.profiler, with device time by kernel group and
   the union of the kernel intervals over the window's device span.
It prints a JSON line of the step profile, one of kernel measurements, then
the nvidia-smi line, and last {"ok": true, "device": {...}}.

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
FOLDER = str(ROOT / "trained_models" / "eddy_gan_64")
DEV = "cuda"
MEMBERS, NX = 10, 64
WARMUP_STEPS, STEPS, SNAP_EVERY = 12, 300, 50
PROFILE_STEPS, QUEUED_STEPS = 30, 5  # 5 steps of ~104 launches stay well
#                                      within the card's launch queue
# float32 rate outside the tensor cores and memory rate of one H100 SXM
# (NVIDIA data sheet, 700 W): K1 computes in exact float32.
PEAK_FP32_FLOPS = 67e12
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


def random_folded(rng, hidden=(128, 64, 32, 32, 32, 32, 32),
                  kernels=(5, 5, 3, 3, 3, 3, 3, 3), n_in=4):
    chans = [n_in] + list(hidden) + [2]
    return {"params": {f"Conv_{i}": {
        "kernel": (rng.standard_normal((k, k, chans[i], chans[i + 1]))
                   / np.sqrt(k * k * chans[i])).astype(np.float32),
        "bias": 0.1 * rng.standard_normal(chans[i + 1]).astype(np.float32)}
        for i, k in enumerate(kernels)}}


def check_k1(fused_conv, folded, B, H, seed):
    """K1 against its plain version on Conv_0's output of a random input;
    returns (packed, K1 input, max |K1 - plain|)."""
    from pyqg_generative_torch.ml.nets import circular_conv2d
    apply = fused_conv.make_online_cnn(folded, device=DEV)
    packed = apply.packed
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = apply.first_layer(torch.randn((B, H, H, 4), generator=gen,
                                      device=DEV))
    out = fused_conv.fused_cnn_forward(x, packed)
    torch.cuda.synchronize()
    ref = fused_conv.fused_cnn_forward_plain(x, packed)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    ok = torch.allclose(out, ref, rtol=2e-4, atol=2e-5 * scale)
    # the same chain in float64 shows both float32 results' own rounding
    act = x.double().permute(0, 3, 1, 2)
    for i, (w, b) in enumerate(zip(packed.weights, packed.biases)):
        act = circular_conv2d(act, w.double(), b.double())
        act = torch.relu(act) if i < len(packed.weights) - 1 else act
    ref64 = act.permute(0, 2, 3, 1)
    log(f"K1 vs plain at B={B}, {H}^2: max|err| {err:.3e}, max|ref| "
        f"{scale:.3e}, within rtol 2e-4 / atol 2e-5*max: {ok}; against "
        f"float64: K1 {float((out.double() - ref64).abs().max()):.3e}, "
        f"plain {float((ref.double() - ref64).abs().max()):.3e}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"B={B}, {H}^2")
    return packed, x, err


def library_chain(x, packed):
    """The same chain as cuDNN convolutions on NCHW input (timed only)."""
    from pyqg_generative_torch.ml.nets import circular_conv2d
    act = x
    for i, (w, b) in enumerate(zip(packed.weights, packed.biases)):
        act = circular_conv2d(act, w, b)
        if i < len(packed.weights) - 1:
            act = torch.relu(act)
    return act


def _group(name: str) -> str:
    low = name.lower()
    if "conv_circular_kernel" in name:
        return "K1 (Conv_1..Conv_7)"
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
    """Where a step's time goes, on one carry of the main path (see phase 6
    in the module's docstring). Returns a dict of ms a step and shares."""
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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            carry = step(carry)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
        "traced_top_kernels_ms_calls_per_step": {
            k: [ms, calls / PROFILE_STEPS] for k, (ms, calls) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:8]}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from pyqg_generative_torch.ml import _build, fused_conv
    from pyqg_generative_torch.ml.nets import fold_batchnorm
    from pyqg_generative_torch.ml.weights import read_msgpack
    from pyqg_generative_torch.models import load_model
    from pyqg_generative_torch.qg import core
    from pyqg_generative_torch.qg.params import QGParams
    from pyqg_generative_torch.sim import init_run_carry, make_online_step, \
        run_ensemble

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

    # 2. build K1
    t0 = time.perf_counter()
    _build.load_library("fused_conv")
    log(f"K1 built in {time.perf_counter() - t0:.1f} s")
    log(_build.library_path("fused_conv").with_suffix(".log").read_text()
        .strip())

    # 3. K1 against its plain version, and its times
    gan = fold_batchnorm(read_msgpack(f"{FOLDER}/G.msgpack"))
    packed, x, err = check_k1(fused_conv, gan, MEMBERS, NX, seed=1)
    check_k1(fused_conv, random_folded(np.random.default_rng(2)), 3, 48,
             seed=2)
    ms = cuda_ms(lambda: fused_conv.fused_cnn_forward(x, packed))
    plain_ms = cuda_ms(lambda: fused_conv.fused_cnn_forward_plain(x, packed))
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    library_ms = cuda_ms(lambda: library_chain(x_nchw, packed))
    flops = fused_conv.flops_per_member(packed.meta, NX, NX) * MEMBERS
    nbytes = 4 * (x.numel() + MEMBERS * NX * NX * packed.meta[-1][2]
                  + packed.wflat.numel() + packed.bflat.numel())
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"K1 at {MEMBERS}x{NX}^2: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"cuDNN chain {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP at 67 TFLOP/s float32, {nbytes / 1e6:.1f}"
        f" MB at 3.35 TB/s) on {smi}")

    # 4. the main path
    model = load_model(FOLDER, device=DEV)
    p = QGParams(nx=NX, dt=14400.0, tavestart=0.0, precision="single")
    closure = {"self": model, "sampling": "AR1", "nsteps": 1}
    run_ensemble(p.replace(tmax=WARMUP_STEPS * p.dt), closure,
                 n_ens=MEMBERS, sampling_freq=WARMUP_STEPS * p.dt,
                 device=DEV)
    fused_conv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = run_ensemble(p.replace(tmax=STEPS * p.dt), closure, n_ens=MEMBERS,
                      sampling_freq=SNAP_EVERY * p.dt, device=DEV)
    wall = time.perf_counter() - t0
    launches = fused_conv.launches
    if launches != STEPS:
        raise AssertionError(f"K1 launched {launches} times in {STEPS} "
                             "steps of one closure call each")
    n_snaps = STEPS // SNAP_EVERY
    for k in ("q", "u", "v", "psi"):
        v = ds[k].values
        if v.shape != (MEMBERS, n_snaps, 2, NX, NX) or \
                not np.isfinite(v).all():
            raise AssertionError(f"{k}: shape {v.shape} or non-finite")
    for k in ("KEspec", "Ensspec", "KEflux", "APEflux", "paramspec",
              "ENSparamspec", "Dissspec"):
        if not np.isfinite(ds[k].values).all():
            raise AssertionError(f"diagnostic {k} is not finite")
    if not (ds["KEspec"].values > 0).any():
        raise AssertionError("no kinetic energy accumulated")
    rate = MEMBERS * STEPS / wall
    log(f"main path: {MEMBERS} members x {STEPS} steps at {NX}^2 in "
        f"{wall:.3f} s = {rate:.1f} member-steps/s, K1 launches {launches}, "
        f"std(q) {ds['q'].values[:, -1].std():.3e} on {smi}")

    # 5. the card's main path against the CPU's, small input, frozen noise
    cpu_model = load_model(FOLDER, device="cpu")
    pq = p.replace(taveint=2 * p.dt)
    q0 = np.stack([core.default_initial_q(
        pq, rng=np.random.default_rng(j)).numpy() for j in range(2)])
    noise = np.random.default_rng(3).standard_normal(
        (2, NX, NX, 2)).astype(np.float32)
    finals = []
    for m, dev in ((model, DEV), (cpu_model, "cpu")):
        step = make_online_step(pq, m, "AR1", -1)
        carry = init_run_carry(pq, q0, 0, m, device=dev)
        carry[1].noise = torch.from_numpy(noise).to(dev)
        for _ in range(10):
            carry = step(carry)
        finals.append(core.fields(carry[0].qh, pq).q.cpu().numpy())
    ref_err = float(np.abs(finals[0] - finals[1]).max())
    ref_scale = float(np.abs(finals[1]).max())
    log(f"card vs CPU main path, 2 members x 10 steps: max|diff| "
        f"{ref_err:.3e} of max|q| {ref_scale:.3e}")
    if not ref_err <= 2e-5 * ref_scale:
        raise AssertionError("the card's main path disagrees with the CPU's")

    # 6. where a step's time goes
    step = make_online_step(p, model, "AR1", 1, with_diags=True)
    carry = init_run_carry(p, np.stack([core.default_initial_q(
        p, rng=np.random.default_rng(j)).numpy() for j in range(MEMBERS)]),
        0, model, device=DEV)
    for _ in range(2 * p.taveints):
        carry = step(carry)
    prof = step_profile(step, carry)
    log(f"step profile, {MEMBERS} x {NX}^2 on {smi}: "
        f"{prof['step_ms']:.4f} ms a step by the host clock; "
        f"{prof['queued_step_ms']} ms with the launches hidden; traced "
        f"window busy {100 * prof['traced_busy_share']:.1f}% of its span")
    print(json.dumps({"step_profile": prof}))

    print(json.dumps({"kernels": [{
        "name": "k1_fused_cnn_forward_f32", "route": "cuda",
        "source": "pyqg_generative_torch/csrc/fused_conv.cu",
        "replaces": "pyqg_generative_tpu/ml/pallas_conv.py:396",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
