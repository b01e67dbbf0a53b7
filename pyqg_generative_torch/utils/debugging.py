"""Numerical-health utilities (the framework's 'sanitizer' layer; the
reference has none — SURVEY §5.2-5.3).

Twin of `pyqg_generative_tpu/utils/debugging.py`. `assert_finite` is a
copy. `debug_nans` is the counterpart of `jax_debug_nans`: a
`TorchDispatchMode` checks the floating and complex outputs of every
operator but views and `empty`, and raises `FloatingPointError` naming the
first operator whose output is not finite; autograd's anomaly mode does the
same for the backward pass. A check reads the device, which a CUDA graph capture cannot,
so while the context is open `sim.graph.GraphedStep` and
`ml.train_graph.GraphedTrainStep` step eagerly, neither capturing nor
replaying (`utils/step_graphs.py`). A kernel of `csrc/` writes its output through its
wrapper, out of the dispatcher's sight: a non-finite value it makes is
named at the first operator that reads it. `first_bad_step` runs over the
port's `init_run_carry` and `advance_run`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import xrlite as xr

__all__ = ["assert_finite", "debug_nans", "first_bad_step", "checks_active"]

# operators whose output is uninitialised memory, not a computed value
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted"}
_active = 0


def checks_active() -> bool:
    """Whether a `debug_nans` context is open (no graph may be captured)."""
    return _active > 0


def assert_finite(ds: xr.Dataset, keys=None):
    """Raise with the offending variable (and first bad time index) if any
    field contains NaN/Inf."""
    for k in (keys or list(ds.keys())):
        v = np.asarray(ds[k].values)
        if not np.isfinite(v).all():
            bad = np.argwhere(~np.isfinite(v))
            raise FloatingPointError(
                f"non-finite values in '{k}' (first at index "
                f"{tuple(bad[0].tolist())}, {(~np.isfinite(v)).sum()} total)")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNINITIALISED:
            return out  # a view computes nothing; empty is uninitialised
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() and (
                    t.is_floating_point() or t.is_complex()) and \
                    not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{func} produced non-finite values "
                    f"({int((~torch.isfinite(t)).sum())} of {t.numel()})")
        return out


@contextlib.contextmanager
def debug_nans():
    """Trap the first operator that produces a NaN or an infinity inside
    the context, forward and backward (slow: each operator's output is read
    back to the host). Graphed steps run eagerly meanwhile."""
    global _active
    _active += 1
    try:
        with torch.autograd.set_detect_anomaly(True), _NanCheck():
            yield
    finally:
        _active -= 1


def first_bad_step(p, q0, max_steps: int = 10000, chunk: int = 100,
                   parameterization=None, device=None):
    """Bisect the first step at which a run goes non-finite: advances in
    chunks, checks the carry on host, returns the step index or -1.
    `device=None` means CUDA."""
    from ..sim.simulate import _normalize_parameterization, advance_run, \
        init_run_carry

    model = _normalize_parameterization(parameterization)[0]
    carry = init_run_carry(p, q0, 0, model, False, device)
    steps = 0
    while steps < max_steps:
        carry, _ = advance_run(carry, p, parameterization, n_snaps=1,
                               sampling_freq=chunk * p.dt, with_diags=False,
                               device=device)
        steps += chunk
        qh = carry[0].qh
        if not bool(torch.isfinite(qh.real).all()
                    & torch.isfinite(qh.imag).all()):
            return steps
    return -1
