"""The port's subgrid-forcing data (`sim/simulate.py::
generate_subgrid_forcing` and its batch version) against the JAX twin's, on
the CPU: a 32^2 DNS in float64, coarse-grained to 16^2 and 8^2 by the
default operators (Operator2, Operator5) with the 3/2-rule, 2 snapshots of
10 steps. The initial condition comes from numpy in both packages, so the
DNS differs only by two FFT libraries rounding at float64; the datasets
hold float32, as both packages cast them, and are held at rtol 1e-10 with
atol 1e-12 of max|ref|. The batch equals the single runs, as
tests/test_sim.py:107 checks of the twin, and each package reads the
other's `.npz`."""
import numpy as np
import pytest
import torch

from pyqg_generative_torch.qg.params import QGParams as TParams
from pyqg_generative_torch.sim import generate_subgrid_forcing, \
    generate_subgrid_forcing_batch
from pyqg_generative_torch.utils import xrlite as txr
from pyqg_generative_tpu.qg.params import QGParams as JParams
from pyqg_generative_tpu.sim import simulate as jsim
from pyqg_generative_tpu.utils import xrlite as jxr

torch.set_num_threads(1)

KW = dict(nx=32, dt=3600.0, tmax=20 * 3600.0, precision="double")
SNAP = 10 * 3600.0
NC = [16, 8]
VARS = ("q_forcing_advection", "q", "u", "v", "psi")


@pytest.fixture(scope="module")
def twin():
    return jsim.generate_subgrid_forcing(NC, JParams(**KW),
                                         sampling_freq=SNAP)


@pytest.fixture(scope="module")
def port():
    return generate_subgrid_forcing(NC, TParams(**KW), sampling_freq=SNAP,
                                    device="cpu")


def _close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())


def test_forcing_matches_twin(port, twin):
    """Every (operator, resolution) dataset: its variables, dims, time and
    grid coordinates and its `pyqg_params` attribute, against the twin's."""
    assert sorted(port) == sorted(twin) == [
        f"Operator{o}-{n}-dealias" for o in (2, 5) for n in (16, 8)]
    for combo, ref in twin.items():
        ds = port[combo]
        nc = int(combo.split("-")[1])
        assert sorted(ds.keys()) == sorted(ref.keys())
        assert ds.attrs == ref.attrs
        assert ds.attrs["pyqg_params"] == str(JParams(**KW).to_dict())
        for v in VARS:
            assert ds[v].dims == ref[v].dims == ("time", "lev", "y", "x")
            assert ds[v].shape == (2, 2, nc, nc)
            _close(ds[v].values, ref[v].values)
            for c in ("time", "x", "y"):
                np.testing.assert_array_equal(ds[v].coords[c],
                                              ref[v].coords[c])
        np.testing.assert_array_equal(ds["time"].values, ref["time"].values)
        assert np.abs(ds["q_forcing_advection"].values).max() > 0


def test_forcing_batch_equals_single(port):
    """Members 0 and 3 advanced together equal their single runs."""
    batch = generate_subgrid_forcing_batch([16], TParams(**KW),
                                           sampling_freq=SNAP, keys=[0, 3],
                                           device="cpu")
    single3 = generate_subgrid_forcing([16], TParams(**KW),
                                       sampling_freq=SNAP, key=3,
                                       device="cpu")
    assert len(batch) == 2
    for member, single in zip(batch, (port, single3)):
        assert sorted(member) == ["Operator2-16-dealias",
                                  "Operator5-16-dealias"]
        for combo in member:
            for v in VARS:
                _close(member[combo][v].values, single[combo][v].values)
    assert not np.allclose(batch[0]["Operator2-16-dealias"]["q"].values,
                           batch[1]["Operator2-16-dealias"]["q"].values)


@pytest.mark.parametrize("writer", ["port", "twin"])
def test_forcing_npz_read_by_the_other(port, twin, writer, tmp_path):
    """A dataset written by one package's xrlite reads back in the other's,
    variables, dims and attributes whole."""
    combo = "Operator2-16-dealias"
    ds = (port if writer == "port" else twin)[combo]
    path = str(tmp_path / "forcing.npz")
    ds.to_npz(path)
    back = (jxr if writer == "port" else txr).Dataset.from_npz(path)
    assert sorted(back.keys()) == sorted(ds.keys())
    assert back.attrs["pyqg_params"] == ds.attrs["pyqg_params"]
    for v in VARS:
        assert back[v].dims == ds[v].dims
        np.testing.assert_array_equal(back[v].values, ds[v].values)
