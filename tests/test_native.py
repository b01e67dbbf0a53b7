"""Native C++ fastloader: build, correctness vs python fallback.

The native loader's producer threads can deadlock (the slot race in
pyqg_generative_tpu/native/fastloader.cpp, ROADMAP queue 3 item 1), so every
test that starts them runs the loader in a child process under `LIMIT`
(`child_limit.run_in_child`) and checks the batches it returns here. A hang
fails that test alone."""
import numpy as np
import pytest

from child_limit import run_in_child
from pyqg_generative_tpu.utils.native import (FastLoader, build_native,
                                              write_sample_store)

LIMIT = 60.0  # seconds a child's loader run may take before it counts as hung


def loader_epochs(folder, seeds, kw):
    """fl.native and every batch of each seed's epoch of FastLoader(folder,
    **kw): what a test's child runs."""
    fl = FastLoader(folder, **kw)
    result = fl.native, [list(fl.epoch(seed=s)) for s in seeds]
    fl.close()
    return result


def native_epochs(tmp_path, folder, seeds, **kw):
    """loader_epochs(folder, seeds, kw) in a child under LIMIT."""
    return run_in_child(loader_epochs, folder, seeds, kw, out=tmp_path,
                        limit=LIMIT)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("store"))
    rng = np.random.default_rng(0)
    n = 103
    arrays = {"q": rng.standard_normal((n, 2, 8, 8)).astype("float32"),
              "S": rng.standard_normal((n, 2, 8, 8)).astype("float32")}
    # tag each sample so identity is recoverable
    arrays["q"][:, 0, 0, 0] = np.arange(n)
    write_sample_store(folder, arrays)
    return folder, arrays


def test_native_builds():
    assert build_native() is not None


def test_native_loader_covers_all_samples(store, tmp_path):
    folder, arrays = store
    native, (epoch,) = native_epochs(tmp_path, folder, [1], batch_size=16)
    assert native, "native library should be active"
    seen = []
    for batch in epoch:
        assert batch["q"].shape == (16, 2, 8, 8)
        assert batch["S"].shape == (16, 2, 8, 8)
        seen.extend(batch["q"][:, 0, 0, 0].astype(int).tolist())
    n = arrays["q"].shape[0]
    assert set(seen) == set(range(n))


def test_native_batches_match_store_content(store, tmp_path):
    folder, arrays = store
    _, (epoch,) = native_epochs(tmp_path, folder, [2], batch_size=8,
                                drop_last=True)
    for batch in epoch:
        ids = batch["q"][:, 0, 0, 0].astype(int)
        np.testing.assert_allclose(batch["S"], arrays["S"][ids], rtol=0)
        np.testing.assert_allclose(batch["q"][:, 1:], arrays["q"][ids, 1:],
                                   rtol=0)


def test_python_fallback_equivalent_semantics(store):
    folder, arrays = store
    fl = FastLoader(folder, batch_size=16, force_python=True)
    assert not fl.native
    seen = []
    for batch in fl.epoch(seed=1):
        assert batch["q"].shape == (16, 2, 8, 8)
        seen.extend(batch["q"][:, 0, 0, 0].astype(int).tolist())
    assert set(seen) == set(range(arrays["q"].shape[0]))


def test_epochs_reshuffle(store, tmp_path):
    folder, _ = store
    # one batch an epoch: each epoch's first batch is all of it
    _, (b1, b2) = native_epochs(tmp_path, folder, [1, 2], batch_size=103,
                                drop_last=True)
    e1 = b1[0]["q"][:, 0, 0, 0]
    e2 = b2[0]["q"][:, 0, 0, 0]
    assert not np.array_equal(e1, e2)
