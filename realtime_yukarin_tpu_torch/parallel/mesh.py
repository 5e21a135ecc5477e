"""The ``data`` x ``model`` layout over the process group (PyTorch port of
``parallel/mesh.py``).

The JAX package shards over a 2-D ``Mesh(('data', 'model'))`` and lets
GSPMD insert the collectives.  The port runs one rank per GPU and writes
the collectives out:

  data   the batch (training rows, serving lanes) splits over the data
         ranks; gradients and the joint loss's partial sums are reduced
         over them;
  model  weights selected by :func:`model_shard_specs` split their output
         channels over the model ranks (Megatron's column split); a layer
         computes its channels, gathers the rest and adds the replicated
         bias (:func:`column_parallel`).

``model`` is innermost, as in the JAX package: ranks ``d*M .. d*M + M-1``
form model group ``d``, so consecutive ranks (one host's cards) share a
model group.  The groups are plain ``torch.distributed.new_group``s:
``DeviceMesh`` binds a rank to ``cuda:(rank % device_count)`` and asks for
one backend per device type, and neither fits ranks that share a card over
gloo or run on the CPU, which plain groups of the default backend do.
DTensor's ``ColwiseParallel`` shards ``nn.Linear`` modules only, while the
port's layers are applied through ``conv1d`` / ``linear`` helpers, which
:func:`column_parallel` serves.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn

from realtime_yukarin_tpu_torch.parallel.multihost import (process_count,
                                                           process_index)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the ``data`` x ``model`` layout and its two
    groups (None where the group is this rank alone)."""
    rank: int
    world: int
    model_parallel: int
    data_group: object = None
    model_group: object = None

    @property
    def data_size(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_parallel}

    def __deepcopy__(self, memo):
        # layers carry their mesh (``model_shard``); a copied layer shares
        # the process groups
        return self


def check_divisible(world: int, model_parallel: int) -> None:
    if model_parallel < 1 or world % model_parallel != 0:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallel={model_parallel}")


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The layout over the process group (one rank when none was joined).
    Every rank calls it with the same ``model_parallel``: the groups are
    made collectively."""
    rank, world = process_index(), process_count()
    check_divisible(world, model_parallel)
    M, D = model_parallel, world // model_parallel
    data_group = model_group = None
    if world > 1:
        if M == 1:
            data_group = dist.group.WORLD
        elif D == 1:
            model_group = dist.group.WORLD
        else:
            for m in range(M):
                g = dist.new_group([d * M + m for d in range(D)])
                if rank % M == m:
                    data_group = g
            for d in range(D):
                g = dist.new_group([d * M + m for m in range(M)])
                if rank // M == d:
                    model_group = g
    return Mesh(rank, world, M, data_group, model_group)


# ---------------------------------------------------------------------------
# The model split
# ---------------------------------------------------------------------------

def shards(weight: torch.Tensor, model_parallel: int) -> bool:
    """The JAX package's rule in torch's layout: a kernel (ndim >= 2) whose
    last flax axis divides ``model_parallel`` and holds at least two
    channels per rank.  That axis is torch's dim 0 for a conv weight
    [out, in, k] (flax [k, in, out]) and a dense weight [out, in] (flax
    [in, out]); biases and other 1-D or 0-D leaves replicate."""
    M = model_parallel
    return (M > 1 and weight.ndim >= 2 and weight.shape[0] % M == 0
            and weight.shape[0] >= 2 * M)


def _layers(tree) -> dict[str, nn.Module]:
    """flax path prefix -> layer for a module (``params/<path>``) or a
    params dict of modules (``<subtree>/params/<path>``)."""
    if isinstance(tree, nn.Module):
        return {f"params/{p}": layer for p, layer in tree.flax_layers().items()}
    return {f"{k}/{n}": layer for k, v in tree.items()
            if isinstance(v, nn.Module) for n, layer in _layers(v).items()}


def model_shard_specs(mesh: Mesh, params) -> dict[str, bool]:
    """{flax name of every layer's kernel and bias: whether it is split
    over ``model``}, for a params dict or one module."""
    out = {}
    for name, layer in _layers(params).items():
        out[f"{name}/kernel"] = shards(layer.weight, mesh.model_parallel)
        out[f"{name}/bias"] = False
    return out


def model_shard(layer: nn.Module) -> Mesh | None:
    """The mesh whose model group splits ``layer``'s weight, or None."""
    return getattr(layer, "model_shard", None)


def _shard_module(mesh: Mesh, net: nn.Module) -> nn.Module:
    for layer in net.flax_layers().values():
        w = layer.weight
        if shards(w, mesh.model_parallel):
            n = w.shape[0] // mesh.model_parallel
            part = w.detach()[mesh.model_index * n:
                              (mesh.model_index + 1) * n].clone()
            layer.weight = nn.Parameter(part, requires_grad=w.requires_grad)
            layer.model_shard = mesh
    return net


def _gather_module(net: nn.Module) -> nn.Module:
    for layer in net.flax_layers().values():
        mesh = model_shard(layer)
        if mesh is not None:
            w = layer.weight
            full = gather_model(w.detach(), mesh, dim=0)
            layer.weight = nn.Parameter(full, requires_grad=w.requires_grad)
            del layer.model_shard
    return net


def _map_modules(fn, params):
    if isinstance(params, nn.Module):
        return fn(copy.deepcopy(params))
    return {k: fn(copy.deepcopy(v)) if isinstance(v, nn.Module) else v
            for k, v in params.items()}


def shard_params(mesh: Mesh, params):
    """A copy of ``params`` (a params dict or one module) whose selected
    weights hold this rank's output channels; other leaves are shared.
    At model_parallel 1 ``params`` itself."""
    if mesh.model_parallel == 1:
        return params
    return _map_modules(lambda net: _shard_module(mesh, net), params)


def gather_params(mesh: Mesh, params):
    """The inverse of :func:`shard_params`: a copy with every weight whole
    (collective over the model group).  ``params`` itself when nothing is
    split."""
    if mesh.model_parallel == 1:
        return params
    return _map_modules(_gather_module, params)


def gather_model(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Concatenate the model group's slices of ``t`` along ``dim``, in
    rank order (no autograd)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model_parallel)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over the model
    group (each rank's slice of the weight gives one part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's slice,
    since everything downstream is computed alike on every rank of the
    group."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.index, ctx.dim, ctx.n = mesh.model_index, dim, y.shape[dim]
        return gather_model(y, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def column_parallel(layer: nn.Module, x: torch.Tensor, local,
                    dim: int) -> torch.Tensor:
    """All output channels of a split ``layer`` on every rank of its model
    group: ``local(x)`` computes this rank's channels (dim ``dim``) from
    its weight slice without the bias; the caller adds the full bias.
    ``x`` must be the same on every rank of the group."""
    mesh = model_shard(layer)
    y = local(_CopyToModel.apply(x, mesh.model_group))
    return _GatherFromModel.apply(y, mesh, dim)


def sharded_leaf_ids(params) -> set[int]:
    """ids of the weights in ``params`` that are model shards."""
    return {id(layer.weight) for layer in _layers(params).values()
            if model_shard(layer) is not None}


def sum_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over the model group (no autograd)."""
    x = x.clone()
    dist.all_reduce(x, group=mesh.model_group)
    return x


# ---------------------------------------------------------------------------
# The data split
# ---------------------------------------------------------------------------

def data_parallel(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.data_size > 1


class _SumOverData(torch.autograd.Function):
    """All-reduce (sum) over the data group forward, identity backward: the
    global value on every rank, and a rank's gradient flows through its own
    partial only, so the parameter gradients sum over the data group."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed elementwise over the data group; the gradient flows to
    this rank's ``x`` unchanged."""
    return _SumOverData.apply(x, mesh.data_group)


def batch_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Mean of ``x`` over the global batch (every rank holds as many rows):
    this rank's sum summed over the data group, over the global count;
    ``torch.mean(x)`` on one data rank."""
    if not data_parallel(mesh):
        return torch.mean(x)
    return sum_over_data(x.sum(), mesh) / (x.numel() * mesh.data_size)


def sum_over_data_(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Sum each tensor over the data group, in place (one collective)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    i = 0
    for t in tensors:
        t.copy_(flat[i: i + t.numel()].view_as(t))
        i += t.numel()
