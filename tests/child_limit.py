"""A test's work in a fresh Python under a time limit of its own.

The reference's native loader can deadlock in its producer threads (ROADMAP
queue 3 item 1). A test that starts them calls `run_in_child`, so that a hang
fails that one test and the run goes on. A thread could not be killed: it
would stay in the worker, under the loader's later `fl_close`. A killed child
takes its threads and its mapping with it.

Run as a script, this file is the child: python tests/child_limit.py DIR LIMIT
calls the function pickled in DIR/call.pkl and pickles what it returns into
DIR/result.pkl."""
import faulthandler
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_in_child(fn, *args, out, limit):
    """fn(*args) in a fresh Python, returning what it returns. `fn` is a
    module-level function of a module in tests/; `out` is a directory of the
    test's own (its `tmp_path`) for the call and the result. The child has
    this environment, JAX_PLATFORMS=cpu and the repo root on PYTHONPATH.

    Past `limit` seconds the child is killed and reaped and the test fails
    with every Python thread's stack, dumped by the child a second before. A
    child that exits non-zero fails the test with its stderr."""
    out = pathlib.Path(out)
    (out / "call.pkl").write_bytes(pickle.dumps((fn, args)))
    path = filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(path))
    try:
        done = subprocess.run([sys.executable, __file__, str(out), str(limit)],
                              env=env, capture_output=True, text=True,
                              timeout=limit)
    except subprocess.TimeoutExpired as exc:
        err = exc.stderr or b""
        if isinstance(err, bytes):
            err = err.decode(errors="replace")
        pytest.fail(f"the child did not finish within {limit} s; its stderr, "
                    f"with its threads' stacks at {limit - 1} s:\n{err}",
                    pytrace=False)
    if done.returncode:
        pytest.fail(f"the child exited with {done.returncode}:\n"
                    f"{done.stderr}", pytrace=False)
    return pickle.loads((out / "result.pkl").read_bytes())


if __name__ == "__main__":
    out, limit = pathlib.Path(sys.argv[1]), float(sys.argv[2])
    faulthandler.dump_traceback_later(limit - 1)
    fn, args = pickle.loads((out / "call.pkl").read_bytes())
    (out / "result.pkl").write_bytes(pickle.dumps(fn(*args)))
