"""``simulator`` backend — cycle-level models as cost oracle + validator.

The paper's phase 1 proper prices every dataflow on the *accelerator's* cycle
models (paper §4–§5), not on a GPU roofline.  This backend exposes exactly
that:

- :meth:`SimulatorBackend.cost` runs the phase-analytical cycle model for the
  dataflow on a deterministic sampled pattern matching the layer's shape and
  densities, and converts cycles to seconds at the Table 5 clock.  N-stationary
  variants are priced as their M dual on the transposed problem (the paper:
  N variants run "in the same manner by exchanging matrices A and B");
- :meth:`SimulatorBackend.execute` runs the plan through the *reference*
  executors, on whatever device the operands are on — the simulator has no
  value path of its own, so execution doubles as numerical validation of
  whatever the cycle models priced.  It is never the main path's backend;
- :meth:`SimulatorBackend.report` returns the full :class:`SimResult`
  (per-phase cycles, on-/off-chip traffic, miss rates) for a plan, or a
  :class:`repro_torch.memory.traffic.TiledSimReport` for a tiled plan,
  or a :class:`repro_torch.memory.traffic.ShardedSimReport` (with the
  interconnect tier) for a sharded one.

Every number it returns equals the JAX package's ``simulator`` backend's on
the same pattern.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import dataflows as df
from ..core.selector import DeviceSpec, LayerShape
from ..core.simulator import LayerSpec, from_layer, simulate
from ..core.simulator.config import PAPER_CONFIG, AcceleratorConfig
from .base import TABLE3_FORMATS, BackendCapability, ExecutionBackend
from .reference import ReferenceBackend

__all__ = ["SimulatorBackend"]

_SIM_OF_BASE = {"ip": "sigma_like", "op": "sparch_like", "gust": "gamma_like"}

#: Seed for the deterministic sampled patterns behind ``cost``/``report``
#: (``from_layer`` switches itself to the analytic expectation for huge
#: layers, so the exact mask path stays bounded).
_STATS_SEED = 0


class SimulatorBackend(ExecutionBackend):
    name = "simulator"
    scan_streaming = True          # executes through the reference path
    schedule_aux_key = None        # no aux schedule — reference execution

    def __init__(self, cfg: AcceleratorConfig = PAPER_CONFIG):
        self.cfg = cfg
        self._ref = ReferenceBackend()
        self._stats_cache: dict = {}

    def capabilities(self) -> BackendCapability:
        return BackendCapability(
            dataflows=tuple(df.DATAFLOWS),
            formats=tuple(set(TABLE3_FORMATS.values())),
            block_multiple=1,
        )

    # -- cost oracle (the paper's phase 1 proper) ------------------------
    def _stats(self, m: int, k: int, n: int, da: float, db: float):
        key = (m, k, n, round(da, 6), round(db, 6))
        st = self._stats_cache.get(key)
        if st is None:
            spec = LayerSpec(name="plan", m=m, n=n, k=k,
                             sp_a=100.0 * (1.0 - da),
                             sp_b=100.0 * (1.0 - db))
            st = from_layer(spec, seed=_STATS_SEED)
            self._stats_cache[key] = st
        return st

    def cost(self, shape: LayerShape, dataflow: str,
             spec: Optional[DeviceSpec] = None) -> float:
        """Simulated execution time in seconds (cycles / Table 5 clock).

        Deterministic for a given (shape, dataflow): the sampled pattern is
        seeded by the layer dimensions and densities.
        """
        del spec  # the cycle models carry their own hardware description
        base = dataflow[:-2]
        if dataflow.endswith("_n"):
            st = self._stats(shape.n, shape.k, shape.m,
                             shape.density_b, shape.density_a)
        else:
            st = self._stats(shape.m, shape.k, shape.n,
                             shape.density_a, shape.density_b)
        cycles = simulate(_SIM_OF_BASE[base], st, self.cfg).cycles
        return cycles / self.cfg.freq_hz

    def report(self, plan):
        """Full cycle-level result for a plan's operation.

        Untiled plans get the single-operation :class:`SimResult`; a
        :class:`repro_torch.memory.TiledPlan` gets a
        :class:`repro_torch.memory.traffic.TiledSimReport` — per-tile
        results plus the aggregated L1/L2/DRAM :class:`TierTraffic` (the
        same numbers the ``simulator`` policy ranks dataflows by under a
        budget).  Each tile is priced under the dataflow it actually runs,
        so mixed plans report a per-tile dataflow histogram
        (``dataflow_histogram``) and per-group tier traffic (``per_group``).
        A :class:`repro_torch.dist.ShardedPlan` gets a
        :class:`repro_torch.memory.traffic.ShardedSimReport`: per-shard
        tier traffic plus the fourth (interconnect) tier of the cross-shard
        merge.
        """
        from ..dist.sharded_plan import ShardedPlan   # lazy: dist uses api
        from ..memory.tiled_plan import TiledPlan     # lazy: memory uses api
        from ..memory.traffic import plan_traffic, sharded_plan_traffic

        if isinstance(plan, ShardedPlan):
            return sharded_plan_traffic(plan, self.cfg, seed=_STATS_SEED)
        if isinstance(plan, TiledPlan):
            return plan_traffic(plan, self.cfg, seed=_STATS_SEED)
        m, k, n = plan.shapes
        da = plan.a_layout.nnzb / max(
            1, math.prod(plan.a_layout.skeleton().grid))
        db = plan.b_layout.nnzb / max(
            1, math.prod(plan.b_layout.skeleton().grid))
        base = plan.dataflow[:-2]
        if plan.dataflow.endswith("_n"):
            st = self._stats(n, k, m, db, da)
        else:
            st = self._stats(m, k, n, da, db)
        return simulate(_SIM_OF_BASE[base], st, self.cfg)

    # -- validation executor ---------------------------------------------
    def prepare(self, plan):
        return self._ref.prepare(plan)

    def execute(self, plan, a, b, out_dtype) -> torch.Tensor:
        return self._ref.execute(plan, a, b, out_dtype)
