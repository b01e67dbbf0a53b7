"""Model weights: flax msgpack files read with `msgpack` alone, and the flax
parameter tree carried across into PyTorch state dicts.

Counterpart of `pyqg_generative_tpu/models/base.py:64-75` (flax
`serialization`) and the inverse of `scripts/port_reference_weights.py`
(torch OIHW -> flax HWIO). A flax msgpack file is a plain msgpack map whose
arrays are extension type 1, each holding `[shape, dtype name, C-order
bytes]`; numpy scalars are extension type 3 in the same format.
"""
from __future__ import annotations

import msgpack
import numpy as np
import torch

__all__ = ["read_msgpack", "params_from_jax"]

_EXT_NDARRAY = 1
_EXT_NATIVE_COMPLEX = 2
_EXT_NPSCALAR = 3


def _ext_hook(code: int, data: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(
            shape, order="C").copy()
    if code == _EXT_NATIVE_COMPLEX:
        re, im = msgpack.unpackb(data, raw=False)
        return complex(re, im)
    raise ValueError(f"unknown msgpack extension type {code}")


def read_msgpack(path: str) -> dict:
    """Nested dict of numpy arrays from a flax `serialization.to_bytes`
    file."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)


def params_from_jax(variables: dict) -> dict:
    """State dict of `ml.nets.AndrewCNN` from its flax tree
    ({'params': {'Conv_i': {kernel HWIO, bias}, 'BatchNorm_i': {scale,
    bias}}, 'batch_stats': {'BatchNorm_i': {mean, var}}}); kernels go from
    HWIO to OIHW."""
    params = variables["params"]
    stats = variables.get("batch_stats", {}) or {}
    sd = {}
    for name, leaf in params.items():
        kind, idx = name.split("_")
        if kind == "Conv":
            sd[f"convs.{idx}.weight"] = torch.from_numpy(
                np.ascontiguousarray(
                    np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)))
            if "bias" in leaf:
                sd[f"convs.{idx}.bias"] = torch.from_numpy(
                    np.array(leaf["bias"]))
        elif kind == "BatchNorm":
            sd[f"bns.{idx}.weight"] = torch.from_numpy(np.array(leaf["scale"]))
            sd[f"bns.{idx}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
            sd[f"bns.{idx}.running_mean"] = torch.from_numpy(
                np.array(stats[name]["mean"]))
            sd[f"bns.{idx}.running_var"] = torch.from_numpy(
                np.array(stats[name]["var"]))
            sd[f"bns.{idx}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(f"unexpected layer {name!r}")
    return sd
