"""Checkpoint of a training carry: a nested tree of arrays in one .npz.

Counterpart of `pyqg_generative_tpu/utils/checkpoints.py` (`save_checkpoint`
:59, `load_checkpoint` :78) for the port's carries: nested dicts, lists and
tuples of torch tensors, numpy arrays and Python numbers, such as module
state dicts (their BatchNorm statistics included) and the optimizers'
states with their update counts. It is written with numpy alone, to a
temporary file that `os.replace` moves into place, in the twin's layout: a
leaf's key is its path joined by "/", a list or tuple item's name its index,
a complex leaf a real and an imaginary part (`//re`, `//im`), None `//none`.
The file is the port's own: a run of the twin does not resume from it, nor
the port from the twin's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def _children(obj):
    if isinstance(obj, dict):
        return [(str(k), v) for k, v in obj.items()]
    return [(str(i), v) for i, v in enumerate(obj)]


def _flatten(prefix: str, obj, out: dict):
    if isinstance(obj, (dict, list, tuple)):
        for k, v in _children(obj):
            _flatten(f"{prefix}/{k}" if prefix else k, v, out)
    elif obj is None:
        out[f"{prefix}//none"] = np.zeros(0)
    else:
        arr = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) \
            else np.asarray(obj)
        if np.iscomplexobj(arr):
            out[f"{prefix}//re"] = arr.real
            out[f"{prefix}//im"] = arr.imag
        else:
            out[prefix] = arr


def save_checkpoint(path: str, tree) -> None:
    """Write `tree` to `path` (".npz" appended where missing), atomically."""
    flat: dict = {}
    _flatten("", tree, flat)
    final = path if path.endswith(".npz") else path + ".npz"
    d = os.path.dirname(final)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, final)


def _restore(prefix: str, template, z):
    if isinstance(template, (dict, list, tuple)):
        items = [(k, _restore(f"{prefix}/{k}" if prefix else k, v, z))
                 for k, v in _children(template)]
        if isinstance(template, dict):
            return type(template)(zip(template.keys(), (v for _, v in items)))
        return type(template)(v for _, v in items)
    if template is None:
        return None
    if f"{prefix}//re" in z:
        arr = z[f"{prefix}//re"] + 1j * z[f"{prefix}//im"]
    else:
        arr = z[prefix]
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr, dtype=template.dtype,
                               device=template.device).reshape(template.shape)
    if isinstance(template, np.ndarray):
        return np.asarray(arr, dtype=template.dtype).reshape(template.shape)
    return type(template)(arr)


def load_checkpoint(path: str, template):
    """The tree saved at `path`, laid out as `template` (e.g. the carry of a
    fresh run): each tensor leaf on the template's device and in its dtype,
    each number of the template's type. Raises if the file's leaves are not
    the template's."""
    flat: dict = {}
    _flatten("", template, flat)
    with np.load(path) as z:
        if set(z.files) != set(flat):
            raise ValueError(f"{path} does not hold the template's leaves: "
                             f"{sorted(set(z.files) ^ set(flat))[:5]}")
        return _restore("", template, z)
