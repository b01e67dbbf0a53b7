"""The native loader's slot race, measured: the JAX package's
`native/fastloader.cpp` against the port's copy, in which it is fixed.

Both sources are built with g++ into a temporary directory (the twin's is
read as a file; nothing of the JAX package is imported). A 103-sample store
is written there, and each library is driven through ctypes in child
processes, one trial a process: epochs of batch 4 (26 batches an epoch, so
every slot of the 4-slot ring is reused within an epoch) and of batch 21 (5
batches), reshuffled each epoch, for --seconds seconds each. A trial that
has not exited --grace seconds after its time is up is counted as hung and
killed. Prints, per source and batch, the hangs out of --trials and the
epochs a second of the trials that ended, and one JSON line last.

    python3 scripts/torch_fastloader_race.py [--trials 6] [--seconds 3]
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = {"twin": ROOT / "pyqg_generative_tpu" / "native" / "fastloader.cpp",
           "port": ROOT / "pyqg_generative_torch" / "native" /
           "fastloader.cpp"}
N_SAMPLES, SAMPLE_FLOATS = 103, 256
BATCHES = (4, 21)

# one trial: epochs until the time is up; prints the epochs it finished
TRIAL = r"""
import ctypes, sys, time
import numpy as np
lib_path, data, n, floats, bs, seconds = sys.argv[1:7]
n, floats, bs, seconds = int(n), int(floats), int(bs), float(seconds)
lib = ctypes.CDLL(lib_path)
lib.fl_open.restype = ctypes.c_long
lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
lib.fl_start_epoch.restype = ctypes.c_long
lib.fl_start_epoch.argtypes = [ctypes.c_long, ctypes.c_ulong, ctypes.c_long,
                               ctypes.c_int]
lib.fl_next_batch.restype = ctypes.c_long
lib.fl_next_batch.argtypes = [ctypes.c_long, ctypes.c_void_p]
lib.fl_close.argtypes = [ctypes.c_long]
h = lib.fl_open(data.encode(), n, floats)
assert h > 0, h
buf = np.empty((bs, floats), np.float32)
epochs, t0 = 0, time.perf_counter()
while time.perf_counter() - t0 < seconds:
    nb = lib.fl_start_epoch(h, epochs, bs, 0)
    seen = set()
    for b in range(nb):
        if lib.fl_next_batch(h, buf.ctypes.data) != b:
            sys.exit("batch out of order")
        seen.update(buf[:, 0].astype(int).tolist())
    if len(seen) != n:
        sys.exit(f"epoch {epochs} missed samples")
    epochs += 1
print(epochs, time.perf_counter() - t0)
lib.fl_close(h)
"""


def build(src: pathlib.Path, out: pathlib.Path) -> str:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", str(src), "-o", str(out)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return str(out)


def trial(lib: str, data: str, bs: int, seconds: float, grace: float):
    """(hung, epochs, seconds) of one child process."""
    proc = subprocess.Popen(
        [sys.executable, "-c", TRIAL, lib, data, str(N_SAMPLES),
         str(SAMPLE_FLOATS), str(bs), str(seconds)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=seconds + grace)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return True, 0, 0.0
    if proc.returncode != 0:
        raise RuntimeError(f"trial failed ({proc.returncode}): {err}")
    epochs, secs = out.split()
    return False, int(epochs), float(secs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--grace", type=float, default=5.0)
    args = ap.parse_args(argv)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        store = np.zeros((N_SAMPLES, SAMPLE_FLOATS), np.float32)
        store[:, 0] = np.arange(N_SAMPLES)  # each sample tagged
        data = str(tmp / "data.bin")
        store.tofile(data)
        libs = {name: build(src, tmp / f"lib{name}.so")
                for name, src in SOURCES.items()}
        for bs in BATCHES:
            for name, lib in libs.items():
                runs = [trial(lib, data, bs, args.seconds, args.grace)
                        for _ in range(args.trials)]
                hung = sum(r[0] for r in runs)
                done = [r for r in runs if not r[0]]
                rate = sum(r[1] for r in done) / sum(r[2] for r in done) \
                    if done else None
                row = {"source": name, "batch": bs,
                       "batches_an_epoch": -(-N_SAMPLES // bs),
                       "trials": args.trials, "hung": hung,
                       "epochs_per_s": rate}
                results.append(row)
                print(f"{name:4s} batch {bs:2d} ({row['batches_an_epoch']} "
                      f"batches an epoch): hung in {hung} of {args.trials} "
                      f"trials of {args.seconds:g} s; epochs/s of the rest: "
                      f"{'-' if rate is None else f'{rate:.1f}'}",
                      flush=True)
    print(json.dumps({"fastloader_race": results, "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
