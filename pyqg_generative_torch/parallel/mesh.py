"""Device-mesh parallelism over torch.distributed: sharded ensembles,
data-parallel and tensor-parallel training.

Twin of `pyqg_generative_tpu/parallel/mesh.py`. One process a device, each
a rank of one torch.distributed group (NCCL on cards, gloo on the CPU;
`parallel.spawn` starts them), and a `DeviceMesh` over the ranks with the
twin's axis names:

* **ensemble parallelism ("ens")**: `run_ensemble(..., sharding=
  ensemble_sharding(mesh))` runs each rank's block of members
  (`MeshSharding.rows`) and gathers every member's output back
  (`MeshSharding.gather`);
* **data parallelism ("dp")**: each rank takes its equal share of the
  batch; `DataParallel` wraps an optimizer so that its step takes the
  ranks' gradients, each scaled by the rank's share of the batch and summed
  over "dp" (each rank's loss is its share of the global mean), and
  `sync_batchnorm` makes a train-mode BatchNorm normalise by, and average
  into its running statistics, the whole batch's statistics;
* **tensor parallelism ("tp")**: `tensor_parallel` splits the output
  channels of the convs and dense layers that `shard_params_tp` shards over
  "tp": each rank holds its slice of the weight (and so of the optimizer's
  state), computes its slice of the output channels and all-gathers them
  before the next layer.

XLA inserts these collectives for the twin's `NamedSharding`s; here they
are written out. Inside "tp" every rank computes the same values outside
the split layers, so a split layer's input is copied in (its gradient
all-reduced over "tp": each rank's output slice contributes a part) and its
output gathered (its gradient the rank's slice); both are autograd
functions whose backward is the other, so a double backward through them,
as in the GAN critic's gradient penalty, is right too.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ml.nets import BatchNorm, BN_MOMENTUM

__all__ = ["make_mesh", "ensemble_sharding", "batch_sharding", "replicated",
           "shard_params_tp", "MeshSharding", "Shard", "Replicate",
           "DataParallel", "sync_batchnorm", "tensor_parallel",
           "gather_state_dict"]


def make_mesh(axis_sizes: dict[str, int] | None = None,
              devices: str | None = None) -> DeviceMesh:
    """A DeviceMesh over the first prod(sizes) ranks of the process group,
    one rank a device. Default: every rank on one 'ens' axis. `devices` is
    the device type ("cuda", "cpu"); None takes the group's (NCCL: cuda)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group, one rank a device (parallel.spawn)")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"ens": world}
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = math.prod(sizes)
    if n > world:
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, "
                         f"have {world}")
    device_type = devices or ("cuda" if dist.get_backend() == "nccl"
                              else "cpu")
    if n == world:
        return init_device_mesh(device_type, sizes, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class Shard:
    """Split along `dim` over a mesh axis (torch.distributed.tensor's
    placement of that name, without importing DTensor)."""
    dim: int


@dataclasses.dataclass(frozen=True)
class Replicate:
    """Whole on every rank."""


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A placement of tensors on a mesh: `Shard(0)` over the mesh axis
    `axis` (the leading dimension split into equal blocks, one a rank), or
    `Replicate()` (axis None)."""
    mesh: DeviceMesh
    axis: str | None
    placement: object

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    @property
    def size(self) -> int:
        return 1 if self.axis is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.axis is None else dist.get_rank(self.group)

    def rows(self, n: int) -> tuple[int, int]:
        """[start, stop) of the n rows this rank owns; raises unless the
        axis splits n evenly (as `jax.device_put` does for the twin)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over the "
                             f"{self.size} ranks of mesh axis {self.axis!r}")
        block = n // self.size
        return self.rank * block, (self.rank + 1) * block

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order, on every rank."""
        if self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=0)


def ensemble_sharding(mesh: DeviceMesh, axis: str = "ens") -> MeshSharding:
    """Shard the leading (member) axis over `axis`."""
    return MeshSharding(mesh, axis, Shard(0))


def batch_sharding(mesh: DeviceMesh, axis: str = "dp") -> MeshSharding:
    return MeshSharding(mesh, axis, Shard(0))


def replicated(mesh: DeviceMesh) -> MeshSharding:
    return MeshSharding(mesh, None, Replicate())


def _splits(shape, tp: int) -> bool:
    """The twin's rule (:60-73) on the port's layout: a conv or dense
    weight, (out, in, kh, kw) or (out, in), whose output channels tp
    divides."""
    return len(shape) >= 2 and shape[0] % tp == 0 and shape[0] >= tp


def shard_params_tp(params, mesh: DeviceMesh, axis: str = "tp"):
    """Placement tree for a tree (dicts) of parameters in the port's layout:
    weights whose output channel count (dim 0) the tp axis divides are
    `Shard(0)` over it, the twin's last dim of flax's HWIO and dense
    kernels; everything else is replicated. Only the mesh's `shape` and
    `mesh_dim_names` are read."""
    tp = mesh.shape[mesh.mesh_dim_names.index(axis)]

    def spec(x):
        if isinstance(x, dict):
            return {k: spec(v) for k, v in x.items()}
        if _splits(tuple(x.shape), tp):
            return MeshSharding(mesh, axis, Shard(0))
        return MeshSharding(mesh, None, Replicate())

    return spec(params)


# --------------------------------------------------------------------------
# collectives as autograd functions (the "tp" group computes replicated
# values outside the split layers)
# --------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """A replicated tensor into a rank's own computation: identity; the
    gradient is the sum of the ranks' parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """The ranks' parts summed into a replicated tensor; the gradient of a
    part is the replicated gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """The ranks' slices along `dim` concatenated in rank order; the
    gradient of a slice is the rank's slice of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    """A replicated tensor's slice along `dim` for this rank; the gradient
    is every rank's slice gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.group), None, None


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------

class ColumnParallel(nn.Module):
    """A conv (nn.Conv2d, NCHW) or dense layer (nn.Linear) whose output
    channels are split over a group: the rank holds rows [start, stop) of
    the weight (`weight`, a Parameter under the layer's own name) and the
    whole bias, computes its channels with no bias, gathers every rank's
    channels and adds the bias."""

    def __init__(self, layer: nn.Module, group):
        super().__init__()
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        n = layer.weight.shape[0]
        lo, hi = rank * n // size, (rank + 1) * n // size
        self.weight = nn.Parameter(layer.weight.detach()[lo:hi].clone())
        self.bias = None if layer.bias is None else \
            nn.Parameter(layer.bias.detach().clone())
        self.group = group
        self.conv = isinstance(layer, nn.Conv2d)
        layer.weight, layer.bias = None, None
        self._layer = (layer,)  # its hyperparameters, not its weights

    def forward(self, x):
        x = _Copy.apply(x, self.group)
        if self.conv:
            y = self._layer[0]._conv_forward(x, self.weight, None)
            y = _Gather.apply(y, 1, self.group)
            return y if self.bias is None else \
                y + self.bias[:, None, None]
        y = _Gather.apply(F.linear(x, self.weight), -1, self.group)
        return y if self.bias is None else y + self.bias


def tensor_parallel(module: nn.Module, mesh: DeviceMesh,
                    axis: str = "tp") -> nn.Module:
    """Replace, in place, each nn.Conv2d (ungrouped) and nn.Linear of
    `module` whose weight `shard_params_tp` shards with its `ColumnParallel`
    slice over `axis`. Parameter names stay; an optimizer initialised after
    this holds the slices' state. Returns the module."""
    group = mesh.get_group(axis)
    tp = dist.get_world_size(group)
    for parent in list(module.modules()):
        for name, layer in list(parent.named_children()):
            ok = isinstance(layer, nn.Linear) or (
                isinstance(layer, nn.Conv2d) and layer.groups == 1)
            if ok and _splits(tuple(layer.weight.shape), tp):
                setattr(parent, name, ColumnParallel(layer, group))
    return module


def gather_state_dict(module: nn.Module) -> dict:
    """The module's state dict with every `ColumnParallel` weight gathered
    whole (on every rank)."""
    out = module.state_dict()
    for name, sub in module.named_modules():
        if isinstance(sub, ColumnParallel):
            w = sub.weight.detach().contiguous()
            parts = [torch.empty_like(w)
                     for _ in range(dist.get_world_size(sub.group))]
            dist.all_gather(parts, w, group=sub.group)
            out[f"{name}.weight" if name else "weight"] = torch.cat(parts)
    return out


# --------------------------------------------------------------------------
# data parallelism
# --------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """The ranks' tensors summed, where each rank's loss is its own share:
    the gradient of a rank's tensor is the sum of every rank's gradient of
    the sum (torch.distributed.nn.functional.all_reduce's rule, which
    PyTorch deprecates)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class SyncBatchNorm(BatchNorm):
    """The port's flax BatchNorm with train-mode statistics over a group:
    the channels' sums and the sample count all-reduced for the mean, then
    the sums of squared deviations from it for the biased variance (flax's
    `use_fast_variance=False`, two passes), through a differentiable
    all-reduce (`_AllReduceSum`), so that the gradient reaches every rank's
    samples. Eval mode is the running statistics'."""

    def __init__(self, bn: BatchNorm, group):
        super().__init__(bn.num_features)
        self.load_state_dict(bn.state_dict())
        self.to(bn.weight.device, bn.weight.dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        count = x.new_full((1,), x.numel() // x.shape[1])
        s = _AllReduceSum.apply(torch.cat([x.sum(dim=(0, 2, 3)), count]),
                                self.group)
        n = s[-1]
        mean = s[:-1] / n
        d = x - mean[:, None, None]
        var = _AllReduceSum.apply((d * d).sum(dim=(0, 2, 3)),
                                  self.group) / n
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return d * mul[:, None, None] + self.bias[:, None, None]


def sync_batchnorm(module: nn.Module, mesh: DeviceMesh,
                   axis: str = "dp") -> nn.Module:
    """Replace, in place, every `ml.nets.BatchNorm` of `module` with a
    `SyncBatchNorm` over `axis`. Returns the module."""
    group = mesh.get_group(axis)
    for parent in list(module.modules()):
        for name, layer in list(parent.named_children()):
            if type(layer) is BatchNorm:
                setattr(parent, name, SyncBatchNorm(layer, group))
    return module


class DataParallel:
    """An optimizer (`ml.train.Adam`: init, step) whose step takes the
    gradient of the global mean loss: each rank's gradient of its own mean
    loss over an equal share of the batch, scaled by 1 / the ranks of
    `axis` and summed over them, in one all_reduce. The summed gradients of
    the last step stay in `last_grads`, by name."""

    def __init__(self, tx, mesh: DeviceMesh, axis: str = "dp"):
        self.tx = tx
        self.group = mesh.get_group(axis)
        self.share = 1.0 / dist.get_world_size(self.group)
        self.last_grads = None

    def init(self, params):
        return self.tx.init(params)

    @torch.no_grad()
    def step(self, params, grads, state):
        grads = list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads]) * self.share
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        self.last_grads = dict(zip(params, out))
        self.tx.step(params, out, state)
