"""The port's multi-replica training (`ml/multifit.py`) on the CPU: each
replica of `fit_gan_ensemble` and `fit_vae_ensemble` bitwise equal to its
own `fit` with the same key (its modules, `G_opt.msgpack` or
`decoder_opt.msgpack`, `epoch_bank/` and `stats.npz`), where the twin's
vmapped run drifts about 5e-5 an epoch (tests/test_multifit.py:26-33);
replicas on datasets of their own (tests/test_multifit.py:75-93); a run
interrupted and resumed bitwise equal to an unbroken one; a torn checkpoint
refused. Narrow nets at 16^2 (the generator 8 wide, the critic 8 wide)."""
import json
import os

import numpy as np
import pytest
import torch

from pyqg_generative_torch.ml import multifit
from pyqg_generative_torch.ml import nets as tnets
from pyqg_generative_torch.models import CGANRegression, CVAERegression
from pyqg_generative_torch.utils import xrlite as txr

from test_torch_train import NX, synthetic

torch.set_num_threads(1)

MISSING = "/nonexistent_model_folder"
SMALL = dict(hidden_channels=(8,))
KEYS = (0, 1)
FIT = dict(num_epochs=3, batch_size=16, nruns=1, verbose=False)


def _gan(folder):
    m = CGANRegression(nx=NX, folder=MISSING, device="cpu", **SMALL)
    m.D = tnets.DCGANDiscriminator(6, ndf=8, nx=NX)
    m.folder = folder
    return m


def _vae(folder):
    m = CVAERegression(folder=MISSING, device="cpu", **SMALL)
    m.encoder = tnets.AndrewCNN(4, 4, **SMALL)
    m.folder = folder
    return m


KINDS = {
    "gan": (_gan, multifit.fit_gan_ensemble, dict(retain_every=1),
            ("G", "D"), ("G.msgpack", "D.msgpack", "G_opt.msgpack",
                         "stats.npz", "epoch_bank/G_1.msgpack",
                         "epoch_bank/G_3.msgpack"), "gan_multi_ckpt.npz"),
    "vae": (_vae, multifit.fit_vae_ensemble, {}, ("encoder", "decoder"),
            ("encoder.msgpack", "decoder.msgpack", "decoder_opt.msgpack",
             "stats.npz"), "vae_multi_ckpt.npz"),
}


@pytest.fixture(scope="module")
def data():
    return (synthetic(txr, 7, nrun=4, ntime=8),
            synthetic(txr, 8, nrun=2, ntime=4))


@pytest.fixture(scope="module")
def singles(data, tmp_path_factory):
    """Each kind's sequential fits, one a key: {kind: [model, ...]}."""
    root = tmp_path_factory.mktemp("singles")
    out = {}
    for kind, (make, _, extra, *_rest) in KINDS.items():
        out[kind] = []
        for key in KEYS:
            m = make(str(root / f"{kind}{key}"))
            m.fit(*data, key=key, **FIT, **extra)
            out[kind].append(m)
    return out


def _assert_same_replica(single, replica, modules, files):
    for name in modules:
        sa = getattr(single, name).state_dict()
        sb = getattr(replica, name).state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    for f in files:
        with open(os.path.join(single.folder, f), "rb") as a, \
                open(os.path.join(replica.folder, f), "rb") as b:
            assert a.read() == b.read(), f


def _ensemble(kind, root, data, **kw):
    make, fit, extra, *_ = KINDS[kind]
    nets = [make(str(root / f"{kind}{key}")) for key in KEYS]
    logs = fit(nets, [data[0]] * 2, [data[1]] * 2, keys=KEYS, **FIT,
               **extra, **kw)
    return nets, logs


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_replicas_equal_their_fits(kind, data, singles, tmp_path):
    """Replica r of the lockstep run is `fit(key=keys[r])` bit for bit:
    its modules, its weights files, best epoch and bank included, and its
    loss log; the two seeds differ; no checkpoint is left."""
    nets, logs = _ensemble(kind, tmp_path, data)
    _, _, _, modules, files, ckpt = KINDS[kind]
    for single, net, log in zip(singles[kind], nets, logs):
        _assert_same_replica(single, net, modules, files)
        assert len(log["L2_total_test"]) == FIT["num_epochs"]
    a, b = (getattr(n, modules[-1]).state_dict() for n in nets)
    assert not all(torch.equal(a[k], b[k]) for k in a)
    assert not os.path.exists(tmp_path / f"{kind}0" / ckpt)


def _crash_after(epoch_stop):
    """_MultiCheckpointer.maybe_save that raises once the checkpoint of
    `epoch_stop` is written."""
    orig = multifit._MultiCheckpointer.maybe_save

    def crashing(self, epoch, trainers):
        orig(self, epoch, trainers)
        if self.path and epoch >= epoch_stop:
            raise KeyboardInterrupt
    return crashing


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_resume_equals_unbroken(kind, data, singles, tmp_path,
                                monkeypatch):
    """A run stopped after epoch 1's checkpoint and started again on the
    same folders ends bit for bit as the unbroken fits; the checkpoint's
    sidecar holds each replica's generators, log and epoch."""
    monkeypatch.setattr(multifit._MultiCheckpointer, "maybe_save",
                        _crash_after(1))
    with pytest.raises(KeyboardInterrupt):
        _ensemble(kind, tmp_path, data, checkpoint_every=1)
    ckpt = tmp_path / f"{kind}0" / KINDS[kind][-1]
    with open(f"{ckpt}.meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and len(meta["generator_states"]) == 2
    assert [len(log["D_loss" if kind == "gan" else "MSE"])
            for log in meta["logs"]] == [1, 1]
    monkeypatch.undo()
    nets, _ = _ensemble(kind, tmp_path, data, checkpoint_every=1)
    _, _, _, modules, files, _ = KINDS[kind]
    for single, net in zip(singles[kind], nets):
        _assert_same_replica(single, net, modules, files)
    assert not ckpt.exists()


def test_torn_checkpoint_raises(data, tmp_path, monkeypatch):
    """A sidecar whose epoch is not the carry's (a crash between the two
    writes) is refused, not resumed."""
    monkeypatch.setattr(multifit._MultiCheckpointer, "maybe_save",
                        _crash_after(1))
    with pytest.raises(KeyboardInterrupt):
        _ensemble("vae", tmp_path, data, checkpoint_every=1)
    monkeypatch.undo()
    meta_path = tmp_path / "vae0" / "vae_multi_ckpt.npz.meta.json"
    meta = json.loads(meta_path.read_text())
    meta["epoch"] = 2
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="torn"):
        _ensemble("vae", tmp_path, data, checkpoint_every=1)


def test_replicas_on_their_own_datasets(data, tmp_path):
    """Two replicas on datasets of their own (twin:
    tests/test_multifit.py:75-93) end as the fits on their own data, with
    their own scalers; datasets of another shape are refused."""
    other = (synthetic(txr, 9, nrun=4, ntime=8),
             synthetic(txr, 10, nrun=2, ntime=4))
    pairs = [data, other]
    fit_kw = dict(FIT, num_epochs=1)
    seq = []
    for key, pair in zip(KEYS, pairs):
        m = _gan(str(tmp_path / f"s{key}"))
        m.fit(*pair, key=key, **fit_kw)
        seq.append(m)
    nets = [_gan(str(tmp_path / f"e{key}")) for key in KEYS]
    multifit.fit_gan_ensemble(nets, [p[0] for p in pairs],
                              [p[1] for p in pairs], keys=KEYS, **fit_kw)
    for m, n in zip(seq, nets):
        _assert_same_replica(m, n, ("G", "D"), ("G.msgpack", "stats.npz"))
        np.testing.assert_array_equal(m.x_scale.std, n.x_scale.std)
    assert not np.array_equal(nets[0].x_scale.std, nets[1].x_scale.std)
    short = (synthetic(txr, 11, nrun=2, ntime=8), data[1])
    with pytest.raises(ValueError, match="identical shapes"):
        multifit.fit_gan_ensemble(
            [_gan(str(tmp_path / f"x{key}")) for key in KEYS],
            [data[0], short[0]], [data[1], short[1]], keys=KEYS, **fit_kw)
