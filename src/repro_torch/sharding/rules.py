"""Sharding rules: logical tensor axes → mesh axes ("pod", "data", "model"),
as DTensor placements.

The port of ``repro.sharding.rules``, with the same scheme (MaxText-style
FSDP + TP hybrid):

- **TP** over "model": column-parallel in-projections (attention QKV, FFN
  up/gate, MoE d_ff, vocab for embed/lm_head), row-parallel out-projections.
- **FSDP** over "data": the non-TP weight dim is sharded over the data axis.
- **DP** over ("pod", "data"): the batch axis; pods are pure data parallel.
- **EP** over "data" for MoE expert dims when divisible (else experts
  replicate and TP shards d_ff within each expert).
- **SP** over "data" for long-context KV caches when the batch cannot be
  sharded.

Each rule gives a :class:`NamedSharding`: the mesh, the reference's
``PartitionSpec``-shaped tuple (one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names) and the DTensor placements it stands for
(one per mesh dim).  The rules are the reference's line for line; the
differences are where the layouts differ:

- the reference's ``_sanitize`` drops every axis that does not divide its
  dim, so DTensor never sees the uneven shard that GSPMD would have padded
  (smollm's 15 heads, vocab 49155);
- JAX stacks each layer's params along a leading layer axis and prepends
  ``None`` for it (``_is_stacked``); the port keeps one param dict per
  layer, in a list, and applies the reference's unstacked spec to each
  layer's leaf.  Path strings name list entries by their index, so the
  substrings the rules test (``"wo"``, ``"x_proj"``, ...) are the
  reference's.

A tuple entry such as ``("pod", "data")`` puts two mesh dims on one tensor
dim.  DTensor shards those in mesh-dim order, the first mesh dim outermost,
which is the reference's order for an entry written in mesh order; an entry
in any other order raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..launch.mesh import mesh_axis_names, mesh_shape

__all__ = ["NamedSharding", "params_sharding", "batch_sharding",
           "cache_sharding", "abstract_like", "distribute", "DATA_AXES"]

DATA_AXES = ("pod", "data")

Spec = Tuple[Any, ...]


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh_axis_names(mesh), mesh_shape(mesh)))


def _placements(spec: Spec, axis_names, sizes=None) -> tuple:
    """The DTensor placements of ``spec``: for each mesh dim, ``Shard(d)``
    where tensor dim ``d``'s entry names it, else ``Replicate()``.  With
    ``sizes`` (axis name -> ranks), a mesh dim of one rank is
    ``Replicate()``: it splits nothing, and DTensor will not reshape a dim
    "sharded" over it (a kv head's dim merged with its repeats)."""
    from torch.distributed.tensor import Replicate, Shard

    where: Dict[str, int] = {}
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        order = [axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {part!r} of dim {dim} is not in mesh order "
                f"{tuple(axis_names)}; DTensor shards one tensor dim over "
                "its mesh dims in mesh order")
        for a in axes:
            where[a] = dim
    return tuple(Shard(where[a]) if a in where
                 and (sizes is None or sizes[a] > 1) else Replicate()
                 for a in axis_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the port's ``jax.sharding.NamedSharding``.

    ``spec`` is the reference's ``PartitionSpec`` as a tuple, one entry per
    tensor dim; :attr:`placements` is what DTensor takes.  ``mesh`` is a
    ``DeviceMesh`` (or anything :func:`repro_torch.launch.mesh.mesh_shape`
    reads, for the spec alone)."""

    mesh: Any = dataclasses.field(compare=False)
    spec: Spec

    @property
    def placements(self) -> tuple:
        return _placements(self.spec, list(mesh_axis_names(self.mesh)),
                           _mesh_axis_sizes(self.mesh))


def _sanitize(spec: Spec, shape, mesh) -> Spec:
    """Drop the axes whose product does not divide the dim (DTensor takes
    no uneven shard here, as jit arguments take no GSPMD padding)."""
    sizes = _mesh_axis_sizes(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts = parts[: len(shape)]
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        kept = []
        prod = 1
        for a in axes:
            if a in sizes and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def _data_axes(mesh):
    names = mesh_axis_names(mesh)
    return tuple(a for a in DATA_AXES if a in names)


def _param_spec(path: str, shape, mesh, cfg) -> Spec:
    """Spec for one *unstacked* parameter (the reference's rules)."""
    sizes = _mesh_axis_sizes(mesh)
    nd = len(shape)
    name = path.split("/")[-1]

    def col():     # (d_in, d_out): FSDP on in, TP on out
        return ("data", "model")

    def row():     # (d_in, d_out): TP on in, FSDP on out
        return ("model", "data")

    if "embed" in path and name == "table":
        return ("model", "data")             # vocab TP, FSDP on d
    if "lm_head" in path:
        return col()
    if name in ("w_gate", "w_up", "w_down", "router") and nd == 3:
        # MoE expert weights (E, D, F) / (E, F, D)
        e = shape[0]
        ep = "data" if (cfg is not None and e % sizes.get("data", 1) == 0) \
            else None
        if name == "w_down":
            return (ep, "model", None if ep else "data")
        return (ep, None if ep else "data", "model")
    if nd == 0:
        return ()
    if nd == 1:
        # biases / norm scales / per-channel vectors: shard big ones on model
        return ("model",) if shape[0] >= 4096 else ()
    if nd == 2:
        if "wo" in path or "w_down" in path or "out_proj" in path \
                or "/cv/" in path or path.endswith("cv/w"):
            return row()
        if "x_proj" in path or "dt_proj" in path:
            return ("model", None) if "x_proj" in path else (None, "model")
        if "a_log" in path:
            return ("model", None)
        if "lora_a" in path:
            return ("data", None)
        if "lora_b" in path:
            return (None, "model")
        if "mu" in path or "u" == name:
            return ()
        # default dense: FSDP in, TP out
        return col()
    if nd == 3:
        return (None, "data", "model")
    return ()


def _walk(tree, fn, path=(), stacked=False):
    """Map ``fn(path, leaf, stacked)`` over a tree of dicts and lists (the
    port's params, caches and batches); ``stacked`` is True under a list
    (the port's layer lists)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),), stacked)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (str(i),), True)
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree, stacked)


def params_sharding(params, mesh, cfg=None):
    """A :class:`NamedSharding` tree beside ``params`` (tensors, meta
    tensors or anything with ``.shape``).  A leaf in a layer list takes the
    reference's spec for its unstacked leaf."""

    def one(path, leaf, _stacked):
        shape = tuple(leaf.shape)
        spec = _param_spec(path, shape, mesh, cfg)
        return NamedSharding(mesh, _sanitize(spec, shape, mesh))

    return _walk(params, one)


def batch_sharding(batch, mesh):
    """Shard the leading (batch) dim over ("pod", "data") when divisible,
    else over "data" alone when that divides, else replicate."""
    axes = _data_axes(mesh)
    sizes = _mesh_axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in axes) if axes else 1

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return NamedSharding(mesh, ())
        b = leaf.shape[0]
        if b % dp == 0 and dp > 1:
            spec = (axes,) + (None,) * (nd - 1)
        elif "data" in sizes and b % sizes["data"] == 0 and sizes["data"] > 1:
            spec = ("data",) + (None,) * (nd - 1)
        else:
            spec = (None,) * nd
        return NamedSharding(mesh, _sanitize(spec, leaf.shape, mesh))

    return {k: one(v) for k, v in batch.items()}


def cache_sharding(cache, mesh, cfg=None):
    """KV/state cache sharding for serving, per leaf of the port's cache.

    The reference's cache leaves are stacked ``(L, B, ...)``; the port's are
    one dict per layer, ``(B, ...)``.  The rule is the reference's on the
    stacked shape, and the port's spec is the stacked spec without its
    layer entry: batch over the data axes when divisible, else sequence
    parallel KV (S over "data"), then the first divisible inner dim over
    "model"."""
    axes = _data_axes(mesh)
    sizes = _mesh_axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in axes) if axes else 1

    def stacked_spec(path, shape):
        b_idx = 1 if len(shape) >= 2 else 0
        spec = [None] * len(shape)
        b = shape[b_idx]
        if b % dp == 0 and dp > 1:
            spec[b_idx] = axes
        elif b % sizes.get("data", 1) == 0 and sizes.get("data", 1) > 1:
            spec[b_idx] = "data"
        elif len(shape) >= 3 and ("k" in path or "v" in path) \
                and shape[2] % sizes.get("data", 1) == 0:
            spec[2] = "data"                      # sequence parallel KV
        model = sizes.get("model", 1)
        inner = range(2, len(shape))
        if "state" in path and len(shape) == 5:
            inner = (2, 3, 4)                      # rwkv: prefer heads
        elif len(shape) == 5:
            inner = (3, 4)                         # attn KV: heads, then dh
        for dim in inner:
            if model > 1 and shape[dim] % model == 0 and shape[dim] >= model:
                spec[dim] = "model"
                break
        return _sanitize(tuple(spec), shape, mesh)

    def one(path, leaf, stacked):
        shape = tuple(leaf.shape)
        if not shape:
            return NamedSharding(mesh, ())
        if stacked:
            # the layer axis JAX stacks in front; its entry is always None
            spec = stacked_spec(path, (1,) + shape)[1:]
        else:
            spec = stacked_spec(path, shape)
        return NamedSharding(mesh, spec)

    return _walk(cache, one)


def abstract_like(tree):
    """A skeleton of ``tree`` on the meta device: same shapes and dtypes,
    no storage (the port's ``jax.ShapeDtypeStruct`` tree)."""
    return _walk(tree, lambda _p, x, _s: torch.empty(
        tuple(x.shape), dtype=x.dtype, device="meta"))


def distribute(tree, shardings):
    """Place each leaf of ``tree`` (dicts, lists and NamedTuples of
    tensors; ``None`` stays) by its :class:`NamedSharding`.

    Every rank holds the whole leaf and keeps its own chunk
    (``distribute_tensor(..., src_data_rank=None)``): no collective, so the
    leaves must be equal on every rank (the same seed, or one checkpoint).
    A meta leaf becomes a meta DTensor of the global shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(leaf, s):
        if leaf is None:
            return None
        if isinstance(leaf, dict):
            return {k: place(v, s[k]) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [place(v, t) for v, t in zip(leaf, s)]
        if isinstance(leaf, tuple):      # a NamedTuple (a train state)
            return type(leaf)(*(place(v, t) for v, t in zip(leaf, s)))
        if leaf.device.type == "meta":
            return DTensor.from_local(_local_chunk(leaf, s), s.mesh,
                                      s.placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())
        return distribute_tensor(leaf, s.mesh, s.placements,
                                 src_data_rank=None)

    return place(tree, shardings)


def _local_chunk(leaf: torch.Tensor, s: NamedSharding) -> torch.Tensor:
    """This rank's chunk of ``leaf`` under ``s`` (the rules' shards are
    even, so every chunk has the global extent over the product)."""
    from torch.distributed.tensor import Shard

    out = leaf
    for mesh_dim, pl in enumerate(s.placements):
        if isinstance(pl, Shard):
            n = s.mesh.size(mesh_dim)
            i = s.mesh.get_local_rank(mesh_dim)
            step = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, i * step, step)
    return out
