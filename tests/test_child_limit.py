"""child_limit.run_in_child: the time limit, a failing child, a result."""
import os
import time

import numpy as np
import pytest

from child_limit import run_in_child


def sleep_forever(pid_file):
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(1e9)


def raise_planted():
    raise ValueError("planted")


def give_back(*args):
    return {"args": args, "a": np.arange(6.0).reshape(2, 3),
            "tags": [[3, 1], [2]], "native": True}


def test_a_hung_child_fails_in_time_and_is_gone(tmp_path):
    pid_file, limit = tmp_path / "pid", 5.0
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="(?s)did not finish within 5.0 s.*"
                             "line [0-9]+ in sleep_forever") as failed:
        run_in_child(sleep_forever, str(pid_file), out=tmp_path, limit=limit)
    assert time.monotonic() - t0 < limit + 10
    assert "test_child_limit.py" in str(failed.value)
    pid = int(pid_file.read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_a_failing_child_fails_with_its_stderr(tmp_path):
    with pytest.raises(pytest.fail.Exception,
                       match="(?s)exited with 1.*ValueError: planted"):
        run_in_child(raise_planted, out=tmp_path, limit=30.0)


def test_a_child_returns_its_result_unchanged(tmp_path):
    out = run_in_child(give_back, "x", 7, out=tmp_path, limit=30.0)
    assert out.keys() == {"args", "a", "tags", "native"}
    assert out["args"] == ("x", 7)
    np.testing.assert_array_equal(out["a"], np.arange(6.0).reshape(2, 3))
    assert out["a"].dtype == np.float64
    assert out["tags"] == [[3, 1], [2]] and out["native"] is True
