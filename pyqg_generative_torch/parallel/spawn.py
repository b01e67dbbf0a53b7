"""Run a function on n ranks of one torch.distributed group, each a child
process, under a hard timeout.

`run_ranks("package.module:function", n, device_type, timeout, kwargs)`
starts n Python processes (`python -m pyqg_generative_torch.parallel.spawn
<spec>`); rank r initialises the group over tcp://localhost:<a free port>
(NCCL on card r for "cuda", gloo for "cpu", where the card is hidden from
the child), calls function(**kwargs), which returns a JSON-able dict, adds
whether the process imported jax, and writes it for the parent. The parent
never hangs: it kills every rank and raises when one exits non-zero, or when
the ranks have not all finished within `timeout` seconds; it returns the
ranks' dicts in rank order. Each rank's output goes to a log whose tail a
failure quotes.
"""
from __future__ import annotations

import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["run_ranks", "free_port"]

_ROOT = Path(__file__).resolve().parent.parent.parent


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 3000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def run_ranks(target: str, n: int, device_type: str = "cpu",
              timeout: float = 600.0, kwargs: dict | None = None) -> list:
    """Run target ("module:function") on ranks 0..n-1 (see the module's
    docstring); returns their result dicts."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if backend == "gloo":
        env["CUDA_VISIBLE_DEVICES"] = ""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs, logs = [], []
        try:
            for rank in range(n):
                spec = {"target": target, "rank": rank, "world": n,
                        "backend": backend, "port": port,
                        "timeout": timeout,
                        "kwargs": kwargs or {},
                        "out": str(tmp / f"rank{rank}.json")}
                path = tmp / f"rank{rank}.spec.json"
                path.write_text(json.dumps(spec))
                logs.append(tmp / f"rank{rank}.log")
                with open(logs[-1], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "pyqg_generative_torch.parallel.spawn", str(path)],
                        stdout=log, stderr=subprocess.STDOUT, env=env,
                        cwd=str(_ROOT)))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"{target}: rank {bad[0]} of {n} exited with code "
                        f"{codes[bad[0]]}:\n{_tail(logs[bad[0]])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    waiting = [r for r, c in enumerate(codes) if c is None]
                    raise RuntimeError(
                        f"{target}: ranks {waiting} of {n} still running "
                        f"after {timeout} s; rank {waiting[0]}'s output:\n"
                        f"{_tail(logs[waiting[0]])}")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return [json.loads((tmp / f"rank{r}.json").read_text())
                for r in range(n)]


def _child(spec_path: str) -> None:
    spec = json.loads(Path(spec_path).read_text())
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)  # ranks share the host's cores
    if spec["backend"] == "nccl":
        torch.cuda.set_device(spec["rank"])
    dist.init_process_group(
        spec["backend"], init_method=f"tcp://localhost:{spec['port']}",
        rank=spec["rank"], world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        result = dict(fn(**spec["kwargs"]) or {})
        result["imported_jax"] = sorted(
            m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "flax", "optax", "pyqg_generative_tpu"))
        Path(spec["out"]).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1])
