"""Meshes a sharded plan can be placed on.

PyTorch runs one process per device, so the port takes two kinds of mesh:

- a **single-process mesh** (:class:`Mesh`): ``n`` shards, all on one
  explicit device, with named axes.  :func:`make_virtual_mesh` gives the
  1-D ``("shards",)`` mesh and :func:`make_local_mesh` the ``(1, 1)``
  ``("data", "model")`` one.  A :class:`repro_torch.dist.ShardedPlan` on
  such a mesh runs its shards one after another on that device;
- a **process-group mesh**: a ``torch.distributed.device_mesh.DeviceMesh``
  (1-D, one rank per shard) over an initialised process group.  A
  ``ShardedPlan`` on it runs one shard per rank and merges the shards'
  results with one ``all_reduce``.

:func:`mesh_shape`, :func:`mesh_axis_names` and :func:`is_process_mesh`
read either kind, so :mod:`repro_torch.dist.partition` keys plans by a
mesh's shape and axis names whatever its kind; :func:`mesh_placement` adds
what the shape leaves out (which kind, and a process mesh's ranks and
group), so that a plan cache never serves one kind's plan to the other.

:func:`make_production_mesh` is the pod mesh the sharding rules
(:mod:`repro_torch.sharding`) place params and batches on: a
``DeviceMesh`` over the whole process group, ``("data", "model")`` or
``("pod", "data", "model")``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import resolve_device

__all__ = ["Mesh", "make_local_mesh", "make_virtual_mesh",
           "make_production_mesh", "mesh_shape", "mesh_axis_names",
           "is_process_mesh", "mesh_placement", "process_mesh_device"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A single-process mesh: ``shape`` shards, all on ``device``.

    Frozen and hashable, like the JAX package's ``Mesh``; two meshes with
    the same shape and axis names give the same plans."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in rank")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape} has an empty axis")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_virtual_mesh(n: int = 8, device=None,
                      axis_name: str = "shards") -> Mesh:
    """A 1-D ``(n,)`` mesh whose shards all run on one device.

    The tests' and ``chip_smoke.py``'s entry point for sharded plans
    (``flexagon_plan(..., mesh=make_virtual_mesh(8, "cpu"))``).
    ``device=None`` is the card (and raises without one)."""
    if n < 1:
        raise ValueError(f"make_virtual_mesh needs n >= 1, got {n}")
    return Mesh((int(n),), (axis_name,), resolve_device(device))


def make_local_mesh(device=None) -> Mesh:
    """The ``(1, 1)`` ``("data", "model")`` mesh of one device."""
    return Mesh((1, 1), ("data", "model"), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod adds a
    pure-DP "pod" axis: (pod=2, data=16, model=16) = 512 ranks.

    A ``DeviceMesh`` over the current process group, which must hold
    exactly that many ranks.  ``device_type`` defaults to ``"cuda"``; the
    tests build it as ``"cpu"`` over a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not torch.distributed.is_initialized():
        raise RuntimeError(
            f"make_production_mesh needs an initialised process group of "
            f"{math.prod(shape)} ranks (torch.distributed.init_process_group)")
    world = torch.distributed.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs "
            f"{math.prod(shape)} ranks; the process group has {world}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def _device_mesh_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh


def is_process_mesh(mesh) -> bool:
    """Is ``mesh`` a ``DeviceMesh`` over a process group?"""
    dm = _device_mesh_type()
    return dm is not None and isinstance(mesh, dm)


def mesh_shape(mesh) -> Optional[Tuple[int, ...]]:
    """The device grid's shape, for either kind of mesh (None for None)."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return tuple(mesh.shape)
    if is_process_mesh(mesh):
        return tuple(int(s) for s in mesh.shape)
    raise TypeError(f"not a mesh: {type(mesh).__name__} (expected "
                    "repro_torch.launch.mesh.Mesh or a DeviceMesh)")


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, Mesh):
        return tuple(mesh.axis_names)
    names = mesh.mesh_dim_names
    return tuple(names) if names is not None else ()


def mesh_placement(mesh) -> Optional[Tuple]:
    """Hashable identity of how a plan on ``mesh`` runs, beside its shape.

    ``None`` for no mesh, ``("single",)`` for a :class:`Mesh` (its shards
    run serially on the plan's device), and for a ``DeviceMesh``
    ``("process", device type, ranks, group name)``: its plan merges over
    that group, so it is never the plan of a single-process caller or of
    another group."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return ("single",)
    if is_process_mesh(mesh):
        ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
        return ("process", mesh.device_type, ranks,
                mesh.get_group().group_name)
    raise TypeError(f"not a mesh: {type(mesh).__name__} (expected "
                    "repro_torch.launch.mesh.Mesh or a DeviceMesh)")


def process_mesh_device(mesh) -> torch.device:
    """This rank's own device on a process-group mesh.

    For a ``cuda`` mesh, the card that is current on this rank, with its
    index: building the ``DeviceMesh`` sets it (``LOCAL_RANK``, else the
    global rank modulo the host's cards) unless the caller set it before.
    A ``cpu`` mesh gives the CPU."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type != "cuda":
        raise ValueError(f"no device rule for a {mesh.device_type!r} mesh; "
                         "pass device= explicitly")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda DeviceMesh, but torch sees no CUDA "
                           "device on this rank")
    return torch.device("cuda", torch.cuda.current_device())
