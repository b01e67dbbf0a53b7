"""The port's debugging, profiling and plot utilities on the CPU, against the
twin's where the twin has the same function."""
import importlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqg_generative_torch import utils as tutils
from pyqg_generative_torch.qg.params import QGParams
from pyqg_generative_torch.sim import init_run_carry, make_online_step
from pyqg_generative_torch.utils import plot as tplot
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_torch.utils.debugging import assert_finite, \
    checks_active, debug_nans, first_bad_step
from pyqg_generative_torch.utils.profiling import measure_throughput, \
    timer, trace
from pyqg_generative_tpu.qg.params import QGParams as JQGParams
from pyqg_generative_tpu.sim import set_initial_condition as jsic
from pyqg_generative_tpu.utils import debugging as jdebugging
from pyqg_generative_tpu.utils import plot as jplot
from pyqg_generative_tpu.utils import profiling as jprofiling
from pyqg_generative_tpu.utils import xrlite as jxr

torch.set_num_threads(1)


def test_assert_finite_is_the_twins():
    msgs = []
    for xr, fn in ((txr, assert_finite), (jxr, jdebugging.assert_finite)):
        ds = xr.Dataset({"q": xr.DataArray(np.ones((2, 3)), ("y", "x"))})
        fn(ds)
        ds["q"].values[1, 2] = np.nan
        with pytest.raises(FloatingPointError, match="q") as e:
            fn(ds)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("dt,max_steps,chunk,expect", [
    (14400.0, 200, 100, -1),          # the twin's clean run
    (20 * 14400.0, 200, 40, 160)])    # 20 x dt: blows up by step 160
def test_first_bad_step_is_the_twins(dt, max_steps, chunk, expect):
    """At 16^2 in float64 from the twin's initial condition: the port's
    first_bad_step finds what the twin's does."""
    q0 = np.asarray(jsic(JQGParams(nx=16, dt=dt, precision="double"), 0))
    twin = jdebugging.first_bad_step(
        JQGParams(nx=16, dt=dt, precision="double"), q0,
        max_steps=max_steps, chunk=chunk)
    port = first_bad_step(QGParams(nx=16, dt=dt, precision="double"),
                          q0.copy(), max_steps=max_steps, chunk=chunk,
                          device="cpu")
    assert port == twin == expect


def test_first_bad_step_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        first_bad_step(QGParams(nx=16), np.zeros((2, 16, 16)), 10, 10)


def _carry_and_step():
    p = QGParams(nx=16, dt=14400.0, precision="double")
    q0 = np.random.default_rng(0).standard_normal((2, 2, 16, 16)) * 1e-6
    return init_run_carry(p, q0, 0, None, True, "cpu"), \
        make_online_step(p, None, with_diags=True)


def test_debug_nans_passes_a_clean_step_and_names_the_first_op():
    carry, step = _carry_and_step()
    assert not checks_active()
    with debug_nans():
        assert checks_active()
        clean = step(carry)
    assert not checks_active()
    ref = step(carry)
    assert torch.equal(clean[0].qh, ref[0].qh)
    carry[0].qh[1, 0, 2, 3] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"^aten\.mul\.Tensor produced non-finite"):
        with debug_nans():
            step(carry)
    assert not checks_active()


def test_debug_nans_traps_the_backward_pass():
    """sqrt(|x|) at 0: the forward is finite, its gradient is not."""
    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    with pytest.raises((FloatingPointError, RuntimeError),
                       match="aten|nan"):
        with debug_nans():
            x.abs().sqrt().sum().backward()


def test_timer_text_is_the_twins(capsys):
    def f(a):
        return a + 1

    assert timer(f)(1) == 2
    port = capsys.readouterr().out
    assert jprofiling.timer(f)(1) == 2
    twin = capsys.readouterr().out
    pattern = r"Function 'f' executed in \d+\.\d{4}s\n"
    assert re.fullmatch(pattern, port) and re.fullmatch(pattern, twin)


def test_measure_throughput_keys_are_the_twins():
    carry, step = _carry_and_step()
    out = measure_throughput(step, carry, n_steps=3, warmup=1)
    twin = jprofiling.measure_throughput(lambda c: c * 2.0,
                                         jnp.ones(4), n_steps=3, warmup=1)
    assert sorted(out) == sorted(twin) == ["ms_per_step", "steps_per_s",
                                           "wall_s"]
    assert out["steps_per_s"] > 0 and np.isclose(
        out["ms_per_step"] * 3, out["wall_s"] * 1e3)


def test_trace_writes_a_chrome_trace(tmp_path):
    carry, step = _carry_and_step()
    with trace(str(tmp_path / "t")):
        step(carry)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("f", [1.5e-07, 3.0, 123456.0, -2.5e-12])
def test_latex_float_is_the_twins(f):
    assert tplot.latex_float(f) == jplot.latex_float(f)


@pytest.mark.parametrize("seed", [0, 1])
def test_outliers_is_the_twins(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(50), 8 + rng.standard_normal(4)])
    out = tplot.outliers(x, seed=seed)
    np.testing.assert_array_equal(out, jplot.outliers(x, seed=seed))
    assert out.sum() == 4


def test_plot_and_native_load_lazily():
    assert importlib.import_module(
        "pyqg_generative_torch.utils.plot") is tutils.plot
    assert tutils.native.FastLoader is not None
    with pytest.raises(AttributeError):
        tutils.nothing_here


def test_imshow_and_create_animation(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    frames = np.random.default_rng(0).standard_normal((3, 8, 8))
    im = tplot.imshow(frames[0])
    assert im.get_array().shape == (8, 8)
    path = tplot.create_animation(frames, str(tmp_path / "a.gif"), fps=5)
    assert path.endswith("a.gif") and (tmp_path / "a.gif").stat().st_size
    import matplotlib.pyplot as plt
    plt.close("all")
