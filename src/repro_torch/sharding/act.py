"""Activation sharding constraints.

The port of ``repro.sharding.act``.  The reference's ``with mesh:`` becomes
:func:`use_mesh`, which names the current ``DeviceMesh``.  Inside it,
``shard(x, *axes)`` redistributes a DTensor ``x`` to the named placements;
with no mesh, or on a plain tensor, it returns ``x`` unchanged, so model
code runs as it is on one device (the tests, serving) and constrained on a
mesh.

Convention: ``"dp"`` expands to the data-parallel axes ("pod", "data")
that exist on the current mesh.  An axis whose size does not divide its
dim is dropped, as the parameter rules drop it: DTensor keeps no uneven
shard where GSPMD would pad.

Inside :func:`use_mesh`, a plain tensor that meets a DTensor in an op counts
as replicated (DTensor's ``implicit_replication``): positions, masks and
RoPE tables are made per call on every rank, as under the reference's mesh
every array that is not constrained is replicated.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .rules import _mesh_axis_sizes, _placements, _sanitize

__all__ = ["use_mesh", "current_mesh", "shard", "dp_axes", "is_dtensor",
           "split_heads", "merge_heads", "grad_placed", "gather_data",
           "gathered_params", "params_gathered", "sum_over_ranks"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)
_GATHERED: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_gathered", default=False)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the current mesh for :func:`shard`
    and treat plain tensors that meet DTensors as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(token)


@contextlib.contextmanager
def gathered_params():
    """While active, the params the model sees are gathered over the data
    axes (:func:`gather_data`), and ``layers.dense`` places each product
    on its rows' shards as GSPMD does (``layers._dense_placed``)."""
    token = _GATHERED.set(True)
    try:
        yield
    finally:
        _GATHERED.reset(token)


def params_gathered() -> bool:
    """Whether :func:`gathered_params` is active."""
    return _GATHERED.get()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or ``None``."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _current_axis_names():
    mesh = current_mesh()
    if mesh is None or mesh.mesh_dim_names is None:
        return ()
    return tuple(mesh.mesh_dim_names)


def dp_axes():
    names = _current_axis_names()
    return tuple(a for a in ("pod", "data") if a in names)


def shard(x, *axes):
    """axes: per-dim entries of None, "model", "data", "dp", or tuples."""
    names = _current_axis_names()
    if not names or not is_dtensor(x):
        return x
    spec = []
    for a in axes:
        if a == "dp":
            d = dp_axes()
            spec.append(d if d else None)
        elif a is None:
            spec.append(None)
        elif isinstance(a, tuple):
            kept = tuple(ax for ax in a if ax in names)
            spec.append(kept if kept else None)
        else:
            spec.append(a if a in names else None)
    mesh = current_mesh()
    placements = _placements(_sanitize(tuple(spec), x.shape, mesh),
                             list(names), _mesh_axis_sizes(mesh))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def split_heads(y, heads: int):
    """``(..., heads * dh) -> (..., heads, dh)``.

    On a DTensor whose last dim is sharded over mesh dims whose product
    does not divide ``heads``, those mesh dims are gathered first: DTensor
    cannot split an uneven shard of heads (GSPMD pads it)."""
    shape = tuple(y.shape[:-1]) + (heads, y.shape[-1] // heads)
    if not is_dtensor(y):
        return y.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard

    last = y.ndim - 1
    mesh = y.device_mesh
    on_last = [i for i, p in enumerate(y.placements)
               if isinstance(p, Shard) and p.dim in (last, -1)]
    prod = 1
    for i in on_last:
        prod *= mesh.size(i)
    if heads % prod:
        placements = [Replicate() if i in on_last else p
                      for i, p in enumerate(y.placements)]
        y = y.redistribute(mesh, placements)
    return y.reshape(shape)


def merge_heads(y):
    """``(..., heads, dh) -> (..., heads * dh)``.

    On a DTensor the gradient that comes back is placed as ``y``'s merged
    shape was in the forward before it is split into heads again: a
    row-parallel projection hands back a gradient sharded along
    ``heads * dh``, which DTensor cannot split into heads that do not divide
    over the mesh (GSPMD pads them)."""
    return grad_placed(y.reshape(tuple(y.shape[:-2])
                                 + (y.shape[-2] * y.shape[-1],)))


def gather_data(x):
    """``x`` with its shards over the data axes ("pod", "data") gathered,
    its other placements kept: the FSDP gather of a parameter before its
    use, as GSPMD gathers a weight sharded over the data axes to meet
    activations sharded by batch.  DTensor's own strategy for such a
    product moves the activations' rows instead, onto every data rank.
    The gradient comes back reduce-scattered to ``x``'s shards.  A plain
    tensor, or one with no data shard, is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names or ()
    placements = tuple(Replicate() if n in ("pod", "data") else p
                       for n, p in zip(names, x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def grad_placed(x):
    """``x`` itself; on a DTensor, the gradient that flows back through
    this use of ``x`` is first redistributed to ``x``'s own placements (a
    redistribute to the placements it has: no collective forward).

    For a tensor whose uses hand back gradients in placements that later
    ops cannot take: a split of an uneven shard, or the sum of two uses'
    gradients (a tied embedding) whose placements some torch versions
    cannot convert into each other."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(SUM)`` of a plain tensor over ``group``, differentiable.

    For a sum of per-rank partials whose consumers are partial too: the
    gradient that reaches each rank is its own partial sum, so the backward
    sums it over the ranks again.  One ``all_reduce`` each way, which gloo
    takes on CUDA tensors (it takes no ``all_gather`` there)."""
    return _SumOverRanks.apply(x, group)
