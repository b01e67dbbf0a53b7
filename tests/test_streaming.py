"""Streaming training via the native loader + debugging utilities."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from child_limit import run_in_child
from pyqg_generative_tpu.ml import nets
from pyqg_generative_tpu.ml import train as T
from pyqg_generative_tpu.models.common import mse_loss_fn
from pyqg_generative_tpu.utils.native import FastLoader, write_sample_store
from pyqg_generative_tpu.utils import xrlite as xr
from pyqg_generative_tpu.utils.debugging import assert_finite, first_bad_step

LIMIT = 120.0  # seconds the child's training may take before it counts as hung


def fit_streaming_losses(folder):
    """Per-epoch losses of 20 epochs of streaming training through the native
    loader. Its threads can deadlock (ROADMAP queue 3 item 1), so the test
    runs this in a child under LIMIT."""
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py sets it
    rng = np.random.default_rng(0)
    X = rng.standard_normal((128, 8, 8, 2)).astype("float32")
    Y = 0.5 * X
    write_sample_store(folder, {"x": X, "y": Y})
    loader = FastLoader(folder, batch_size=32)

    net = nets.AndrewCNN(n_out=2, hidden_channels=(8,), batch_norm=False)
    tx = T.multistep_adam(3e-3, 20, 4)
    state = T.init_training_state(net, tx, jax.random.PRNGKey(0),
                                  jnp.asarray(X[:1]))
    state, log = T.fit_streaming(mse_loss_fn(net), state, tx, loader,
                                 ("x", "y"), num_epochs=20, verbose=False)
    loader.close()
    return log["loss"]


def test_fit_streaming_converges(tmp_path):
    loss = run_in_child(fit_streaming_losses, str(tmp_path / "store"),
                        out=tmp_path, limit=LIMIT)
    assert loss[-1] < 0.3 * loss[0]


def test_assert_finite():
    ds = xr.Dataset({"q": xr.DataArray(np.ones((2, 3)), ("y", "x"))})
    assert_finite(ds)
    ds["q"].values[1, 2] = np.nan
    with pytest.raises(FloatingPointError, match="q"):
        assert_finite(ds)


def test_first_bad_step_clean_run():
    from pyqg_generative_tpu.qg.params import QGParams
    from pyqg_generative_tpu.sim import set_initial_condition
    p = QGParams(nx=16, dt=14400.0, precision="double")
    q0 = set_initial_condition(p, 0)
    assert first_bad_step(p, q0, max_steps=200, chunk=100) == -1
