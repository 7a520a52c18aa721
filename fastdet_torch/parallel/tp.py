"""Tensor parallel over a 2-D (data, model) mesh (counterpart of
fastdet/parallel/tp.py).

The JAX package annotates its parameters' shardings and lets GSPMD insert
the collectives.  The port runs one process per device, so it shards the
parameters itself and carries its own collectives, each an autograd
function, over the model group of a module's `Shard`:

  * `Shard.copy` (`_CopyToModel`): the identity forward; the backward
    sums the input's gradient over the model group;
  * `Shard.gather` (`_GatherFromModel`): the forward all-gathers the
    shards (in rank order, rank m's block m) along a dim (an
    activation's channels, a weight's dim 0); the backward keeps the
    rank's own slice.

`tensor_parallel` hands each sharded module its `Shard`, so the models
import nothing of this package.  A sharded layer (`models/layers.py`:
`ConvBN`, `head_conv`) takes the full activation through the copy,
computes its own output channels (a depthwise conv on its slice of the
input's channels), normalises them with statistics over the data group,
applies ReLU and hands the next layer the full activation through the
gather.  Everything between two
sharded layers computes alike on every model rank, so its gradients are
the same full tensors on each: the gather's backward must keep its slice
and not sum them, and only the copy, behind which each rank's compute
differs, sums.  Replicated modules (the 3-channel obj head) compute whole
on every model rank.

Rules, on the full shapes (`leaf_spec`, JAX's `_leaf_spec` in torch's
layouts): a conv weight (cout, cin/g, kh, kw), a dense (out, in) and a
1-D vector shard dim 0 where it divides the model axis; everything else
replicates.  They cover parameters, BN running statistics and the SGD
momentum buffers (built on the local shards).  On a 1-D mesh everything
replicates.

Gloo has no `all_gather` for CUDA tensors and no `reduce_scatter`, so a
gather is a zero-padded `all_reduce` (`multihost.all_gather_stacked`):
exact, on every backend.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from fastdet_torch.models.layers import ConvBN
from fastdet_torch.parallel.mesh import DATA_AXIS, _default_device
from fastdet_torch.parallel.multihost import all_gather_stacked, world

MODEL_AXIS = "model"


class Mesh2D:
    """A (data, model) mesh.  In a job, rank r sits at (d, m) with r = d ·
    n_model + m; `data_group` holds the ranks with its m (the batch
    splits over them), `model_group` those with its d (the channels
    split over them), `group` the world.  In one process (`group` None)
    it only lays out `devices`: training on it raises."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, n_data: int, n_model: int,
                 devices: Sequence[torch.device], rank: int = 0, group=None,
                 data_group=None, model_group=None):
        self.n_data, self.n_model = n_data, n_model
        self.devices = tuple(torch.device(d) for d in devices)
        self.rank = rank
        self.group = group
        self.data_group = data_group
        self.model_group = model_group

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def coords(self):
        """(d, m) of this rank."""
        return divmod(self.rank, self.n_model)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        where = (f"rank {self.rank} at {self.coords}" if self.group
                 is not None else "local")
        return (f"Mesh2D({self.n_data}x{self.n_model}, {where}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh_2d(n_data: int, n_model: int,
                 devices: Optional[Sequence[Any]] = None) -> Mesh2D:
    """The (data, model) mesh.  In a job of n_data · n_model ranks: this
    rank on `devices[0]` if given, else on its card (rank modulo the
    cards), with its data and model groups; every rank creates every
    group, in the same order.  In one process: the first n_data · n_model
    of `devices` (repeats allowed), else of the local cards."""
    n = n_data * n_model
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if size != n:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n} ranks, "
                             f"the job has {size}")
        dev = torch.device(devices[0]) if devices else _default_device(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        model_groups = [dist.new_group([d * n_model + m
                                        for m in range(n_model)])
                        for d in range(n_data)]
        data_groups = [dist.new_group([d * n_model + m
                                       for d in range(n_data)])
                       for m in range(n_model)]
        d, m = divmod(rank, n_model)
        return Mesh2D(n_data, n_model, [dev], rank, dist.group.WORLD,
                      data_groups[m], model_groups[d])
    if devices is None:
        _default_device(0)                  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh2D(n_data, n_model, devices[:n])


# ------------------------------------------------------------- the rules

def leaf_spec(shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dim of a tensor of `shape` that shards over the model axis, or
    None (replicated): dim 0 of a conv weight, a dense weight or a vector
    where the model axis divides it."""
    if len(shape) in (1, 2, 4) and shape[0] % n_model == 0:
        return 0
    return None


def state_shardings(state: Dict[str, Any], mesh) -> Dict[str, Optional[int]]:
    """{key: sharded dim or None} of a full state dict on `mesh`; on a 1-D
    mesh everything replicates.  Non-tensor entries replicate."""
    if MODEL_AXIS not in mesh.axis_names:
        return {k: None for k in state}
    n = mesh.shape[MODEL_AXIS]
    return {k: leaf_spec(v.shape, n) if torch.is_tensor(v) else None
            for k, v in state.items()}


def own(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Block `rank` of `n` equal contiguous blocks of t along `dim`."""
    c = t.shape[dim] // n
    return t.narrow(dim, rank * c, c)


def shard_state(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shards of a full state dict."""
    specs = state_shardings(state, mesh)
    if all(dim is None for dim in specs.values()):
        return dict(state)
    _, m = mesh.coords
    return {k: v if specs[k] is None
            else own(v, specs[k], m, mesh.n_model).clone()
            for k, v in state.items()}


def gather_state(state: Dict[str, Any], mesh,
                 specs: Dict[str, Optional[int]]) -> Dict[str, Any]:
    """The full state dict, on every rank, from this rank's shards
    `state` and the full state's `specs` (`state_shardings`)."""
    out = {}
    for k, v in state.items():
        if specs.get(k) is None:
            out[k] = v
        else:
            parts = all_gather_stacked(v.detach().contiguous(),
                                       mesh.model_group)
            out[k] = torch.cat(list(parts.unbind(0)), specs[k])
    return out


# ------------------------------------------------------- the collectives

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the group's shards along `dim`, in rank order; the
    backward keeps this rank's slice of the (full, and on every rank
    equal) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim = dim
        ctx.rank, ctx.n = world(group)
        parts = all_gather_stacked(x.contiguous(), group)
        return torch.cat(list(parts.unbind(0)), dim)

    @staticmethod
    def backward(ctx, g):
        return own(g, ctx.dim, ctx.rank, ctx.n).contiguous(), None, None


# ---------------------------------------------------------- the converter

class Shard:
    """A module's place on the model axis (its `group` and this rank's
    block `rank` of `size`) and the collectives its forward runs."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def own(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return own(t, dim, self.rank, self.size)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x into a layer whose compute differs over the model ranks."""
        return _CopyToModel.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The full tensor from this rank's shard along `dim` (an NCHW
        activation's channels by default)."""
        return _GatherFromModel.apply(x, dim, self.group)


def tensor_parallel(model: torch.nn.Module, mesh: Mesh2D
                    ) -> Dict[str, Optional[int]]:
    """Shard `model` in place over the mesh's model axis: every parameter
    and buffer keeps this rank's block of its sharded dim, and every
    sharded `ConvBN` and every sharded bare conv (the heads) gets its
    `Shard` (`.shard`), which the layers' forwards read.
    The BatchNorms' statistics are not touched here: give them the data
    group (`sync_batchnorm`).  → the full model's `state_shardings`."""
    if mesh.group is None:
        raise NotImplementedError(
            "fastdet_torch: tensor parallel runs one process per device: "
            "start a job (initialize_distributed) and pass its "
            "make_mesh_2d()")
    specs = state_shardings(model.state_dict(), mesh)
    local = shard_state(model.state_dict(), mesh)
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        if specs[name] is not None:
            t.data = local[name]
    shard = Shard(mesh.model_group, mesh.coords[1], mesh.n_model)
    inner = {id(m.conv) for m in model.modules() if isinstance(m, ConvBN)}
    for name, mod in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(mod, ConvBN):
            if specs[prefix + "conv.weight"] is not None:
                mod.shard = shard
        elif isinstance(mod, nn.Conv2d) and id(mod) not in inner:
            if specs[prefix + "weight"] is not None:
                mod.shard = shard
    return specs


def replicated_params(model: torch.nn.Module,
                      specs: Dict[str, Optional[int]]
                      ) -> List[torch.nn.Parameter]:
    """The parameters that every model rank holds whole."""
    return [p for name, p in model.named_parameters() if specs[name] is None]
