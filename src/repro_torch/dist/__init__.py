"""``repro_torch.dist`` — sharded plan execution across a mesh.

Placement as the fourth pillar, orthogonal to dataflow choice, format and
tiling:

- :class:`Partitioner` / :class:`DistPartition` — per-dataflow shard
  strategies over the block grid (IP output-region panels, OP k-slabs with
  an ``all_reduce`` merge, Gust row bands with replicated B);
- :class:`ShardedPlan` — per-shard ``FlexagonPlan``/``TiledPlan``\\ s
  composed into one apply: one shard per rank merged by one
  ``torch.distributed`` ``all_reduce`` on a process-group mesh, the shards
  one after another on a single-process mesh
  (:mod:`repro_torch.launch.mesh`);
- the cross-shard partial-sum merge is priced as an **interconnect traffic
  tier** alongside L1/L2/DRAM (:mod:`repro_torch.memory.traffic`).

Entry point: ``flexagon_plan(a, b, mesh=make_virtual_mesh(8))`` partitions
the plan across the mesh; ``partition=DistPartition(axis=..., shards=...)``
overrides the strategy.
"""
from .partition import (DEFAULT_AXIS, DistPartition, Partitioner,
                        default_axis, merge_ici_bytes, mesh_key,
                        resolve_shards)
from .sharded_plan import ShardedPlan, plan_sharded

__all__ = [
    "DEFAULT_AXIS",
    "DistPartition",
    "Partitioner",
    "default_axis",
    "merge_ici_bytes",
    "mesh_key",
    "resolve_shards",
    "ShardedPlan",
    "plan_sharded",
]
