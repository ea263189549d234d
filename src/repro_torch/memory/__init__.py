"""``repro_torch.memory`` — tiled out-of-core execution (the paper's 3rd
pillar).

The memory-hierarchy layer between plans and backends:

- :class:`MemoryBudget` — the on-chip capacity tiers (L1 FIFOs/PSRAM,
  SpMSpM-customized L2) as a byte budget; :data:`PAPER_BUDGET` is Table 5;
- :mod:`~repro_torch.memory.tiling` — per-dataflow
  :class:`TileScheduler`\\ s that partition one SpMSpM at pattern
  granularity until every tile fits (IP C-tiles / OP k-slabs / Gust row
  bands), plus the tile-level :class:`TileMergePlan`;
- :class:`TiledPlan` — per-tile ``FlexagonPlan``\\ s composed into one
  ``apply`` (one kernel launch per tile on the ``cuda`` backend; OP slabs
  add into one carry in slab order);
- :mod:`~repro_torch.memory.traffic` — L1/L2/DRAM pricing per tile
  (:class:`TierTraffic`), consumed by the simulator backend's ``report``
  and by traffic-aware selection policies; the ``sharded_*`` functions add
  the interconnect tier of a :class:`repro_torch.dist.ShardedPlan`.

Entry point: ``flexagon_plan(a, b, memory_budget=MemoryBudget(...))``
auto-tiles whenever the pattern exceeds the budget.
``flexagon_plan(a, b, dataflow="mixed", memory_budget=...)`` additionally
makes dataflow a *per-tile* decision: the :class:`MixedTileScheduler` tiles
the output grid into disjoint C regions and the selection policy's
``select_tile`` picks each tile's dataflow on the tile's own occupancy
slice.

The budget is the paper's (Table 5), as in the JAX package: this port adds
no budget of its own for the H100.
"""
from .budget import MemoryBudget, PAPER_BUDGET, operand_bytes, output_bytes
from .tiled_plan import TiledPlan, mixed_tile_dataflows, plan_tiled
from .tiling import (GustTileScheduler, IPTileScheduler, MixedTileScheduler,
                     OPTileScheduler, Tile, TileMergePlan, TileScheduler,
                     get_scheduler, schedule)
from .traffic import (ShardedSimReport, TierTraffic, TiledSimReport,
                      mixed_tile_choices, plan_traffic, sharded_estimate,
                      sharded_plan_traffic, sharded_traffic,
                      synthetic_occupancy, tiled_estimate, tiled_traffic)

__all__ = [
    "MemoryBudget",
    "PAPER_BUDGET",
    "operand_bytes",
    "output_bytes",
    "Tile",
    "TileMergePlan",
    "TileScheduler",
    "IPTileScheduler",
    "OPTileScheduler",
    "GustTileScheduler",
    "MixedTileScheduler",
    "get_scheduler",
    "schedule",
    "TiledPlan",
    "plan_tiled",
    "mixed_tile_dataflows",
    "mixed_tile_choices",
    "TierTraffic",
    "TiledSimReport",
    "plan_traffic",
    "synthetic_occupancy",
    "tiled_estimate",
    "tiled_traffic",
    "ShardedSimReport",
    "sharded_traffic",
    "sharded_plan_traffic",
    "sharded_estimate",
]
