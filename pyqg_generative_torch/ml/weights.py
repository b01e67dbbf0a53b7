"""Model weights: flax msgpack files read and written with `msgpack` alone,
and the flax variable tree carried across to PyTorch state dicts and back.

Counterpart of `pyqg_generative_tpu/models/base.py:58-66` (flax
`serialization`). A flax msgpack file is a plain msgpack map whose arrays
are extension type 1, each holding `[shape, dtype name, C-order bytes]`;
numpy scalars are extension type 3 in the same format.

The port's modules (`ml/nets.py`) name every layer as flax does, so a state
dict key is a flax path: `ResUnit_3.Conv_1.weight` is
`params/ResUnit_3/Conv_1/kernel`. A layer's kind is read off its name:
`Conv` (HWIO <-> OIHW), `ConvTranspose` (HWIO <-> IOHW, the kernel flipped
in both spatial axes, see `ml/nets.py`), `Dense` ((in, out) <-> (out, in))
and `BatchNorm` (scale, bias in `params`; mean, var in `batch_stats`).
"""
from __future__ import annotations

import msgpack
import numpy as np
import torch

__all__ = ["read_msgpack", "to_msgpack_bytes",
           "params_from_jax", "params_to_jax", "seeded_variables"]

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


def _ext_pack(x):
    """flax's `_msgpack_ext_pack`: arrays as type 1, numpy scalars as 3."""
    if isinstance(x, np.ndarray):
        code = _EXT_NDARRAY
    elif isinstance(x, np.generic):
        code, x = _EXT_NPSCALAR, np.asarray(x)
    elif isinstance(x, complex):
        return msgpack.ExtType(_EXT_NATIVE_COMPLEX,
                               msgpack.packb((x.real, x.imag)))
    else:
        return x
    return msgpack.ExtType(code, msgpack.packb(
        (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))


def read_msgpack(path: str) -> dict:
    """Nested dict of numpy arrays from a flax `serialization.to_bytes`
    file."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {str(k): _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree if isinstance(tree, (np.ndarray, np.generic)) \
        else np.asarray(tree)


def to_msgpack_bytes(variables: dict) -> bytes:
    """The bytes flax's `serialization.to_bytes` writes for a tree of
    arrays (numpy or torch)."""
    return msgpack.packb(_numpy_tree(variables), default=_ext_pack,
                         strict_types=True)


def _leaves(tree: dict, prefix=()):
    """(path, layer dict) of every layer (a dict of arrays) of a flax tree."""
    for name, sub in tree.items():
        if isinstance(sub, dict) and sub and not any(
                isinstance(v, dict) for v in sub.values()):
            yield prefix + (name,), sub
        elif isinstance(sub, dict):
            yield from _leaves(sub, prefix + (name,))


def _kind(name: str) -> str:
    return name.rsplit("_", 1)[0]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def params_from_jax(variables: dict) -> dict:
    """The state dict of the port's module of the same layout as a flax
    tree ({'params': ..., 'batch_stats': ...}, nested submodules
    included)."""
    stats = variables.get("batch_stats", {}) or {}
    sd = {}
    for path, leaf in _leaves(variables["params"]):
        key, kind = ".".join(path), _kind(path[-1])
        if kind == "Conv":
            sd[f"{key}.weight"] = _tensor(np.asarray(
                leaf["kernel"]).transpose(3, 2, 0, 1))
        elif kind == "ConvTranspose":
            sd[f"{key}.weight"] = _tensor(np.asarray(
                leaf["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        elif kind == "Dense":
            sd[f"{key}.weight"] = _tensor(np.asarray(leaf["kernel"]).T)
        elif kind == "BatchNorm":
            st = stats
            for name in path:
                st = st[name]
            sd[f"{key}.weight"] = _tensor(leaf["scale"])
            sd[f"{key}.running_mean"] = _tensor(st["mean"])
            sd[f"{key}.running_var"] = _tensor(st["var"])
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(f"unexpected layer {key!r}")
        if "bias" in leaf:
            sd[f"{key}.bias"] = _tensor(leaf["bias"])
    return sd


def _set(tree: dict, path, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def params_to_jax(state_dict: dict) -> dict:
    """The flax tree ({'params', 'batch_stats'}) of a state dict of the
    port's modules: the inverse of `params_from_jax`, arrays as numpy in
    their dtype."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        *path, attr = key.split(".")
        kind, a = _kind(path[-1]), t.detach().cpu().numpy()
        if attr == "num_batches_tracked":
            continue
        if attr == "running_mean":
            _set(stats, path + ["mean"], a)
        elif attr == "running_var":
            _set(stats, path + ["var"], a)
        elif attr == "bias":
            _set(params, path + ["bias"], a)
        elif kind == "BatchNorm":
            _set(params, path + ["scale"], a)
        elif kind == "Conv":
            _set(params, path + ["kernel"],
                 np.ascontiguousarray(a.transpose(2, 3, 1, 0)))
        elif kind == "ConvTranspose":
            _set(params, path + ["kernel"], np.ascontiguousarray(
                a.transpose(2, 3, 0, 1)[::-1, ::-1]))
        elif kind == "Dense":
            _set(params, path + ["kernel"], np.ascontiguousarray(a.T))
        else:
            raise ValueError(f"unexpected layer {key!r}")
    return {"params": params, "batch_stats": stats}


def seeded_variables(module: torch.nn.Module, seed: int) -> dict:
    """A flax tree of `module`'s layout filled from numpy's generator seeded
    with `seed`: kernels N(0, 1/fan-in), biases N(0, 0.1^2), BatchNorm
    scales 1 + N(0, 0.1^2), shifts N(0, 0.1^2), means N(0, 0.1^2) and
    variances in [0.5, 1.5): random weights at the module's widths."""
    rng = np.random.default_rng(seed)
    tree = params_to_jax(module.state_dict())

    def fill(sub, kind):
        for leaf, a in sub.items():
            if isinstance(a, dict):
                fill(a, _kind(leaf))
                continue
            if leaf == "kernel":
                fan_in = a.size // a.shape[-1] if kind != "ConvTranspose" \
                    else a.shape[0] * a.shape[1] * a.shape[3]
                v = rng.standard_normal(a.shape) / np.sqrt(fan_in)
            elif leaf == "scale":
                v = 1 + 0.1 * rng.standard_normal(a.shape)
            elif leaf == "var":
                v = 0.5 + rng.random(a.shape)
            else:
                v = 0.1 * rng.standard_normal(a.shape)
            sub[leaf] = v.astype(np.float32)

    fill(tree["params"], "")
    fill(tree["batch_stats"], "")
    return tree
