"""The port's native sample loader and `fit_streaming` on the CPU.

The loader is the port's copy of the twin's `fastloader.cpp` with its slot
race and lost wakeup fixed; g++ builds it at first use. No test here calls
the twin's native loader, which hangs (ROADMAP queue 3 item 1): the twin is
read through its numpy path (`force_python=True`), which shares the port's
numpy order. Every test that starts the native loader's threads joins them
under a time limit of its own, so none can hang the run."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.ml import train as tt
from pyqg_generative_torch.ml.weights import params_from_jax, \
    params_to_jax, seeded_variables
from pyqg_generative_torch.models import common as tcommon
from pyqg_generative_torch.utils import native
from pyqg_generative_torch.utils.native import FastLoader, build_native, \
    write_sample_store
from pyqg_generative_tpu.ml import nets as jnets
from pyqg_generative_tpu.ml import train as jt
from pyqg_generative_tpu.models import common as jcommon
from pyqg_generative_tpu.utils import native as jnative

torch.set_num_threads(1)

N = 103
LIMIT = 30.0  # seconds a test's loader run may take before it counts as hung


def run_limited(fn, limit=LIMIT):
    """fn() in a daemon thread joined with a limit; fails on a timeout
    (the thread is left behind, as a daemon, rather than hang the run)."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised in the test's thread
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(limit)
    if t.is_alive():
        pytest.fail(f"the loader did not finish within {limit} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The twin's store of tests/test_native.py: 103 samples, q and S of
    (2, 8, 8), each tagged with its index in q[:, 0, 0, 0]."""
    folder = str(tmp_path_factory.mktemp("store"))
    rng = np.random.default_rng(0)
    arrays = {"q": rng.standard_normal((N, 2, 8, 8)).astype("float32"),
              "S": rng.standard_normal((N, 2, 8, 8)).astype("float32")}
    arrays["q"][:, 0, 0, 0] = np.arange(N)
    write_sample_store(folder, arrays)
    return folder, arrays


def tags(batch):
    return batch["q"][:, 0, 0, 0].astype(int).tolist()


def epochs(fl, seeds, **kw):
    return run_limited(lambda: [[tags(b) for b in fl.epoch(seed=s, **kw)]
                                for s in seeds])


def test_native_builds_into_the_package_build_dir():
    path = build_native()
    assert os.path.exists(path) and path == str(native.library_path())
    assert os.path.dirname(path).endswith(os.path.join(
        "pyqg_generative_torch", "build"))


@pytest.mark.parametrize("writer", ["port", "twin"])
def test_store_round_trip_both_packages(writer, tmp_path):
    """A store written by either package reads back the same through the
    port's native loader and both packages' numpy loaders."""
    rng = np.random.default_rng(1)
    arrays = {"x": rng.standard_normal((10, 4, 4, 2)).astype("float32"),
              "y": rng.standard_normal((10, 3)).astype("float32")}
    arrays["x"][:, 0, 0, 0] = np.arange(10)
    folder = str(tmp_path / "s")
    (write_sample_store if writer == "port" else jnative.write_sample_store)(
        folder, arrays)
    with open(os.path.join(folder, "meta.json")) as f:
        assert json.load(f)["sample_floats"] == 4 * 4 * 2 + 3
    loaders = [FastLoader(folder, batch_size=10, drop_last=True),
               FastLoader(folder, batch_size=10, force_python=True),
               jnative.FastLoader(folder, batch_size=10, force_python=True)]
    assert loaders[0].native and not loaders[2].native
    for fl in loaders:
        b = run_limited(lambda: next(iter(fl.epoch(seed=3))))
        ids = b["x"][:, 0, 0, 0].astype(int)
        assert sorted(ids.tolist()) == list(range(10))
        np.testing.assert_array_equal(b["x"], arrays["x"][ids])
        np.testing.assert_array_equal(b["y"], arrays["y"][ids])
    loaders[0].close()


def test_native_loader_covers_every_sample(store):
    folder, _ = store
    fl = FastLoader(folder, batch_size=16)
    assert fl.native
    (seen,) = epochs(fl, [1])
    assert len(seen) == 7 and all(len(b) == 16 for b in seen)
    assert set(sum(seen, [])) == set(range(N))
    fl.close()


def test_native_batches_match_store_content(store):
    folder, arrays = store
    fl = FastLoader(folder, batch_size=8, drop_last=True)

    def check():
        for batch in fl.epoch(seed=2):
            ids = batch["q"][:, 0, 0, 0].astype(int)
            np.testing.assert_array_equal(batch["S"], arrays["S"][ids])
            np.testing.assert_array_equal(batch["q"][:, 1:],
                                          arrays["q"][ids, 1:])
    run_limited(check)
    fl.close()


@pytest.mark.parametrize("drop_last,n_batches", [(True, 12), (False, 13)])
def test_native_drop_last(store, drop_last, n_batches):
    folder, _ = store
    fl = FastLoader(folder, batch_size=8, drop_last=drop_last)
    (seen,) = epochs(fl, [4])
    assert len(seen) == n_batches == fl.n_batches()
    ids = sum(seen, [])
    assert len(set(ids)) == (96 if drop_last else N)
    fl.close()


def test_native_last_batch_wraps(store):
    """The last batch of 16 over 103 samples holds the epoch's last 7 and
    then its first 9 (twin :99)."""
    folder, _ = store
    fl = FastLoader(folder, batch_size=16)
    (seen,) = epochs(fl, [5])
    assert seen[-1][7:] == seen[0][:9]
    assert set(seen[-1][:7]).isdisjoint(sum(seen[:-1], []))
    fl.close()


def test_native_epochs_reshuffle(store):
    folder, _ = store
    fl = FastLoader(folder, batch_size=N, drop_last=True)
    e1, e2, e1_again = epochs(fl, [1, 2, 1])
    assert e1 != e2 and e1 == e1_again
    fl.close()


@pytest.mark.parametrize("batch_size", [16, 8])
def test_force_python_batches_are_twins(store, batch_size):
    """The port's numpy path is the twin's, bitwise, over several epochs;
    into a ring of output buffers too."""
    folder, _ = store
    port = FastLoader(folder, batch_size=batch_size, force_python=True)
    twin = jnative.FastLoader(folder, batch_size=batch_size,
                              force_python=True)
    ring = [np.empty((batch_size, port.sample_floats), np.float32)
            for _ in range(2)]
    for seed in (0, 1, 7):
        pairs = zip(port.epoch(seed=seed), twin.epoch(seed=seed))
        for a, b in pairs:
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        for a, b in zip(port.epoch(seed=seed, out=ring),
                        twin.epoch(seed=seed)):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_native_output_ring(store):
    """Batch b lands in out[b % 3], after before_fill(b % 3), and the dict
    holds views of it."""
    folder, arrays = store
    fl = FastLoader(folder, batch_size=16)
    ring = [torch.empty((16, fl.sample_floats)) for _ in range(3)]
    calls = []

    def run():
        for b, batch in enumerate(fl.epoch(seed=6, out=ring,
                                           before_fill=calls.append)):
            buf = ring[b % 3].numpy()
            assert np.shares_memory(batch["q"], buf)
            ids = batch["q"][:, 0, 0, 0].astype(int)
            np.testing.assert_array_equal(batch["S"], arrays["S"][ids])
    run_limited(run)
    assert calls == [b % 3 for b in range(7)]
    with pytest.raises(ValueError, match="output buffer"):
        next(fl.epoch(out=[np.empty((8, fl.sample_floats), np.float32)]))
    fl.close()


def test_twin_hang_regime_completes(store):
    """200 epochs of 26 batches of 4 over the 103 samples, where the twin's
    loader hangs in its first epochs (scripts/torch_fastloader_race.py):
    every epoch covers every sample."""
    folder, _ = store
    fl = FastLoader(folder, batch_size=4)

    def run():
        for e in range(200):
            seen = [t for b in fl.epoch(seed=e) for t in tags(b)]
            assert len(seen) == 104 and set(seen) == set(range(N)), e
    run_limited(run)
    fl.close()


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback to numpy: a compiler that is missing raises, and so does
    a store that fl_open refuses."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler-here")
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="did not build"):
        build_native()
    folder = str(tmp_path / "s")
    write_sample_store(folder, {"x": np.zeros((4, 3), np.float32)})
    with pytest.raises(RuntimeError, match="did not build"):
        FastLoader(folder, batch_size=2)
    assert not FastLoader(folder, batch_size=2, force_python=True).native


def test_short_store_raises(tmp_path):
    folder = str(tmp_path / "s")
    write_sample_store(folder, {"x": np.zeros((4, 3), np.float32)})
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    meta["n_samples"] = 5
    with open(os.path.join(folder, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="shorter"):
        FastLoader(folder, batch_size=2)


# ------------------------------------------------------------ fit_streaming

def _streaming_store(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((128, 8, 8, 2)).astype("float32")
    folder = str(tmp_path / "store")
    write_sample_store(folder, {"x": X, "y": 0.5 * X})
    return folder, X


def _nets(dtype=torch.float64):
    """The twin's tests/test_streaming.py net (AndrewCNN, hidden (8,), no
    BatchNorm) in the port and the twin, on the same seeded weights."""
    port = tnets.AndrewCNN(2, 2, hidden_channels=(8,), batch_norm=False)
    tree = seeded_variables(port, 3)
    port.load_state_dict(params_from_jax(tree))
    port = port.to(dtype)
    twin = jnets.AndrewCNN(n_out=2, hidden_channels=(8,), batch_norm=False,
                           dtype=jnp.float64)
    params = {k: {kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
              for k, v in tree["params"].items()}
    return port, twin, params


def test_fit_streaming_is_the_twins(tmp_path):
    """20 epochs of 4 batches (multistep_adam(3e-3, 20, 4)) in float64 on
    both packages' numpy loaders over one store: per-epoch losses and the
    final weights at rtol 1e-10 (weights to each tensor's largest)."""
    folder, _ = _streaming_store(tmp_path)
    port, twin, params = _nets()
    jtx = jt.multistep_adam(3e-3, 20, 4)
    jstate = jt.TrainingState(params, {}, jtx.init(params),
                              jnp.zeros((), int))
    jstate, jlog = jt.fit_streaming(
        jcommon.mse_loss_fn(twin), jstate, jtx,
        jnative.FastLoader(folder, batch_size=32, force_python=True),
        ("x", "y"), num_epochs=20, verbose=False)
    ttx = tt.multistep_adam(3e-3, 20, 4)
    state = tt.TrainingState(port, ttx.init(tt.named_params(port)))
    state, log = tt.fit_streaming(
        tcommon.mse_loss_fn(port), state, ttx,
        FastLoader(folder, batch_size=32, force_python=True), ("x", "y"),
        num_epochs=20, verbose=False)
    assert state.step == 80 and state.opt_state["count"] == 80
    assert list(log) == list(jlog) == ["loss"]
    np.testing.assert_allclose(log["loss"], jlog["loss"], rtol=1e-10)
    out = params_to_jax(port.state_dict())["params"]
    for layer, leaves in jstate.params.items():
        for leaf, ref in leaves.items():
            ref = np.asarray(ref)
            err = np.abs(out[layer][leaf] - ref).max() / np.abs(ref).max()
            assert err <= 1e-10, (layer, leaf, err)


def test_fit_streaming_converges_on_the_native_loader(tmp_path):
    """The twin's test (tests/test_streaming.py:16-31) on the port's native
    loader, in float32."""
    folder, _ = _streaming_store(tmp_path)
    port, _, _ = _nets(torch.float32)
    loader = FastLoader(folder, batch_size=32)
    assert loader.native
    tx = tt.multistep_adam(3e-3, 20, 4)
    state = tt.TrainingState(port, tx.init(tt.named_params(port)))
    state, log = run_limited(lambda: tt.fit_streaming(
        tcommon.mse_loss_fn(port), state, tx, loader, ("x", "y"),
        num_epochs=20, verbose=False))
    assert log["loss"][-1] < 0.3 * log["loss"][0]
    loader.close()


def test_fit_streaming_hands_draws_the_seeded_generator(tmp_path):
    """`draws(generator, batch)` is appended to each batch; the generator is
    seeded with `key`, so a run is repeatable."""
    folder, _ = _streaming_store(tmp_path)
    seen = []

    def loss_fn(batch, train):
        x, y, noise = batch
        seen.append(float(noise.sum()))
        return tcommon.mse_loss_fn(port)((x + 0 * noise, y), train)

    def draws(generator, batch):
        return (torch.randn(batch[0].shape, generator=generator,
                            dtype=batch[0].dtype),)

    runs = []
    for _ in range(2):
        port, _, _ = _nets()
        tx = tt.multistep_adam(3e-3, 1, 4)
        state = tt.TrainingState(port, tx.init(tt.named_params(port)))
        seen.clear()
        tt.fit_streaming(loss_fn, state, tx,
                         FastLoader(folder, batch_size=32,
                                    force_python=True),
                         ("x", "y"), 1, key=5, draws=draws, verbose=False)
        runs.append(list(seen))
    assert len(runs[0]) == 4 and runs[0] == runs[1]
    assert len(set(runs[0])) == 4
