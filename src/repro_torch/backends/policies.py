"""Dataflow ``SelectionPolicy`` — the swappable half of phase 1.

The paper's mapper/compiler estimates every dataflow's cost and picks one.
This module is that seam:

- :class:`HeuristicPolicy` — the analytical roofline estimate
  (:func:`repro_torch.core.selector.select_dataflow`), the default;
- :class:`SimulatorPolicy` — pick by simulated cycles on the cycle-level
  accelerator models — the paper's phase 1 proper;
- :class:`AutotunePolicy`  — measure every candidate dataflow on the device
  at plan time and pick the fastest, LRU-cached by pattern fingerprint;
- :class:`FixedPolicy`     — always the given dataflow (what an explicit
  ``dataflow="ip_m"`` argument resolves to).

The JAX package's ``learned`` policy and autotune's persistent ``TuneDB``
are not ported yet (ROADMAP queue 1, item 11); naming them raises
``NotImplementedError``.

A policy sees one :class:`SelectionContext` (shape features, occupancy
bitmaps, fingerprint, the target backend) and returns a dataflow name from
``ctx.allowed`` — the dataflows the backend's capability declaration admits.
``layer_cost`` is the same oracle exposed per (layer, dataflow) for the
network-level DP (:func:`repro_torch.core.selector.plan_network`).
"""
from __future__ import annotations

import abc
import dataclasses
import hashlib
import itertools
import os
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import resolve_device
from ..core import dataflows as df
from ..core.selector import DeviceSpec, LayerShape, estimate, select_dataflow
from .base import ExecutionBackend, allowed_dataflows, get_backend

__all__ = [
    "SelectionContext",
    "SelectionPolicy",
    "HeuristicPolicy",
    "SimulatorPolicy",
    "AutotunePolicy",
    "FixedPolicy",
    "get_policy",
]


@dataclasses.dataclass
class SelectionContext:
    """Everything phase 1 knows when it asks a policy to choose.

    ``occ_a``/``occ_b`` are block-occupancy bitmaps (the pattern itself, for
    policies that measure); ``allowed`` is pre-negotiated against the
    backend's capability declaration.  ``memory_budget`` (a
    :class:`repro_torch.memory.MemoryBudget`, or ``None`` for unbounded)
    makes the choice traffic-aware: policies rank dataflows by what their
    *tiled* execution moves through the L1/L2/DRAM tiers.  ``mesh`` /
    ``partition`` (a :mod:`repro_torch.launch.mesh` mesh and a
    :class:`repro_torch.dist.DistPartition`) make it placement-aware: each
    dataflow is priced as its *sharded* execution — slowest shard plus the
    cross-shard merge over the interconnect tier — so policies rank
    (dataflow × partition) jointly.  ``device`` is where a measuring
    policy runs its throwaway plans (``None``: the card).
    """

    shape: LayerShape
    block_shape: Tuple[int, int, int]
    occ_a: np.ndarray
    occ_b: np.ndarray
    fingerprint: str
    backend: ExecutionBackend
    spec: DeviceSpec
    allowed: Tuple[str, ...]
    memory_budget: Optional[Any] = None
    mesh: Optional[Any] = None
    partition: Optional[Any] = None
    #: a :class:`repro_torch.memory.Tile` when this is a *per-tile*
    #: selection inside a ``dataflow="mixed"`` plan: ``shape`` / ``occ_a`` /
    #: ``occ_b`` / ``fingerprint`` then describe that tile's own occupancy
    #: slice and ``memory_budget`` is ``None`` — the mixed scheduler already
    #: shrank the tile until it is residency-feasible, so policies price
    #: each candidate as one resident operation.
    tile: Optional[Any] = None
    device: Optional[Any] = None

    @property
    def n_shards(self) -> int:
        """Shard count the (mesh, partition) pair resolves to (1 = local)."""
        from ..dist.partition import resolve_shards   # lazy: dist uses api

        return resolve_shards(self.mesh, self.partition)


class SelectionPolicy(abc.ABC):
    """One dataflow-selection strategy (see module docstring)."""

    name: str = "abstract"

    #: key under which a :class:`repro_torch.api.PlanCache` files plans
    #: built with this policy; stateful policies override.
    @property
    def cache_key(self) -> str:
        return self.name

    @property
    def stats(self) -> Dict[str, Any]:
        """Telemetry counters (surfaced as ``ServeEngine.stats["policy"]``).

        Stateful policies extend with their own counters (autotune's
        hit/miss/measurement counts).
        """
        return {"name": self.name}

    @abc.abstractmethod
    def select(self, ctx: SelectionContext) -> str:
        """Pick one dataflow from ``ctx.allowed``."""

    def select_tile(self, ctx: SelectionContext) -> str:
        """Pick one dataflow for a single tile of a ``"mixed"`` plan.

        ``ctx`` carries the tile's own occupancy slice (``ctx.tile`` names
        the tile) with no memory budget — the tile is residency-feasible by
        construction, so the whole-operation ``select`` paths price it as
        one resident operation: heuristic by the tile-shape roofline,
        simulator by the tile's cycle model, autotune by measuring a
        throwaway plan on the tile slice (cached by the tile fingerprint).
        """
        return self.select(ctx)

    def layer_cost(self, shape: LayerShape, dataflow: str,
                   spec: Optional[DeviceSpec] = None,
                   memory_budget: Optional[Any] = None) -> float:
        """Per-(layer, dataflow) cost in seconds for the network DP.

        With a ``memory_budget`` the cost is the *tiled* execution's
        (per-tile roofline sums + cross-tile merge traffic)."""
        if memory_budget is not None:
            from ..memory.traffic import tiled_estimate   # lazy: no cycle

            return tiled_estimate(shape, dataflow, memory_budget,
                                  spec or DeviceSpec()).time_s
        return estimate(shape, dataflow, spec or DeviceSpec()).time_s

    # -- conveniences ----------------------------------------------------
    def select_for_shape(self, shape: LayerShape, *,
                         backend: Union[str, ExecutionBackend] = "reference",
                         spec: DeviceSpec = DeviceSpec(),
                         dtype="float32") -> str:
        """Select for shape features alone (dense-pattern context).

        For callers that have no concrete pattern, e.g. MoE dispatch
        planning, where the routing pattern only exists at run time.  The
        fingerprint carries the block shape and value dtype, as in the JAX
        package.
        """
        be = get_backend(backend)
        bm, bk, bn = shape.block
        occ_a = np.ones((-(-shape.m // bm), -(-shape.k // bk)), dtype=bool)
        occ_b = np.ones((-(-shape.k // bk), -(-shape.n // bn)), dtype=bool)
        ctx = SelectionContext(
            shape=shape, block_shape=tuple(shape.block), occ_a=occ_a,
            occ_b=occ_b,
            fingerprint=f"shape:{shape.m}x{shape.k}x{shape.n}"
                        f":{shape.density_a:.4f}:{shape.density_b:.4f}"
                        f":b{bm}x{bk}x{bn}:{np.dtype(dtype).name}",
            backend=be, spec=spec,
            allowed=allowed_dataflows(be, tuple(shape.block)))
        return self.select(ctx)


class HeuristicPolicy(SelectionPolicy):
    """The analytical roofline estimate (paper §5.2 traffic formulas).

    Under a memory budget the per-dataflow estimate becomes the tiled sum
    (each dataflow tiles differently, so re-stream and merge traffic now
    separate the candidates).
    """

    name = "heuristic"

    def select(self, ctx: SelectionContext) -> str:
        shards = ctx.n_shards
        if shards > 1:
            from ..memory.traffic import sharded_estimate

            axis = getattr(ctx.partition, "axis", None)
            return min(ctx.allowed, key=lambda d: (
                sharded_estimate(ctx.shape, d, shards,
                                 budget=ctx.memory_budget, spec=ctx.spec,
                                 occ_a=ctx.occ_a, occ_b=ctx.occ_b,
                                 axis=axis), d))
        if ctx.memory_budget is not None:
            from ..memory.traffic import tiled_estimate

            return min(ctx.allowed, key=lambda d: (
                tiled_estimate(ctx.shape, d, ctx.memory_budget, ctx.spec,
                               occ_a=ctx.occ_a, occ_b=ctx.occ_b).time_s, d))
        return select_dataflow(ctx.shape, ctx.spec, allowed=ctx.allowed)


class SimulatorPolicy(SelectionPolicy):
    """Pick by simulated cycles — the paper's phase 1 proper.

    Deterministic for a fixed fingerprint: the cycle models price a
    deterministic sampled pattern; ties break by dataflow name.  Under a
    memory budget each candidate is priced as its *tiled* execution — the
    per-tile cycle models plus the cross-tile merge traffic
    (:func:`repro_torch.memory.traffic.tiled_traffic`), so the choice
    consumes the same per-tier numbers ``SimulatorBackend.report`` exposes.
    """

    name = "simulator"

    def __init__(self, backend: Union[str, ExecutionBackend] = "simulator"):
        self._sim = backend

    def _oracle(self) -> ExecutionBackend:
        return get_backend(self._sim)

    def _cfg(self):
        from ..core.simulator.config import PAPER_CONFIG

        return getattr(self._oracle(), "cfg", PAPER_CONFIG)

    def price(self, ctx: SelectionContext) -> Dict[str, float]:
        """Simulated time per allowed dataflow — ``select`` is its argmin."""
        sim = self._oracle()
        shards = ctx.n_shards
        if shards > 1:
            from ..memory.traffic import sharded_traffic

            cfg = self._cfg()
            axis = getattr(ctx.partition, "axis", None)
            return {d: sharded_traffic(
                d, ctx.occ_a, ctx.occ_b, ctx.block_shape, shards,
                budget=ctx.memory_budget, cfg=cfg, axis=axis).time_s(cfg)
                for d in ctx.allowed}
        if ctx.memory_budget is not None:
            from ..memory.traffic import tiled_traffic

            cfg = self._cfg()
            return {d: tiled_traffic(
                d, ctx.occ_a, ctx.occ_b, ctx.block_shape,
                ctx.memory_budget, cfg).time_s(cfg) for d in ctx.allowed}
        return {d: sim.cost(ctx.shape, d, ctx.spec) for d in ctx.allowed}

    def select(self, ctx: SelectionContext) -> str:
        costs = self.price(ctx)
        return min(ctx.allowed, key=lambda d: (costs[d], d))

    def layer_cost(self, shape: LayerShape, dataflow: str,
                   spec: Optional[DeviceSpec] = None,
                   memory_budget: Optional[Any] = None) -> float:
        if memory_budget is not None:
            from ..memory.traffic import synthetic_occupancy, tiled_traffic

            cfg = self._cfg()
            mb, kb, nb = shape.grid
            occ_a = synthetic_occupancy((mb, kb), shape.density_a)
            occ_b = synthetic_occupancy((kb, nb), shape.density_b, seed=1)
            return tiled_traffic(dataflow, occ_a, occ_b, tuple(shape.block),
                                 memory_budget, cfg).time_s(cfg)
        return self._oracle().cost(shape, dataflow, spec)


class AutotunePolicy(SelectionPolicy):
    """Measure every candidate dataflow on the device at plan time.

    For each new pattern fingerprint the policy synthesizes values on the
    pattern, builds a throwaway fixed-dataflow plan per candidate on the
    *target* backend and device, times ``plan.apply``, and picks the
    fastest.  On a CUDA device each ``apply`` is timed by a pair of
    ``torch.cuda.Event``\\ s after a synchronize; on the CPU by the wall
    clock.  Results are cached by ``(fingerprint, backend, block_shape,
    budget, mesh shape, partition, device)``, so a serving loop pays the
    sweep once per pattern — and repeat selections are deterministic by
    construction.  On a process-group mesh every rank measures and all
    take the first rank's pick, so the ranks plan the same shards.

    The cache is **LRU-bounded** (``maxsize``).  ``hits`` / ``misses`` /
    ``measurements`` / ``evictions`` counters mirror the ``PlanCache``
    telemetry and surface through ``ServeEngine.stats["policy"]``.

    Backends may declare **tuning knobs**
    (:meth:`repro_torch.backends.ExecutionBackend.tuning_knobs`, e.g. the
    cuda dense-escape threshold): the sweep then measures the (dataflow ×
    knob) cross product jointly and applies the winning knob values to the
    backend instance before the real plan is built.
    :meth:`select_block` measures candidate block shapes the same way.

    The JAX package's persistent, fleet-shared ``TuneDB`` (``db=``,
    ``REPRO_TUNE_DB``) is not ported yet (ROADMAP queue 1, item 11): asking
    for one raises, and the cache lives in this process only.
    """

    name = "autotune"

    def __init__(self, reps: int = 2, maxsize: Optional[int] = 1024,
                 db: Optional[Any] = None):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 or None, got {maxsize}")
        if db is not None or os.environ.get("REPRO_TUNE_DB"):
            raise NotImplementedError(
                "AutotunePolicy's persistent TuneDB (db= / REPRO_TUNE_DB) "
                "is not ported yet: ROADMAP queue 1, item 11 (tune/)")
        self.reps = reps
        self.maxsize = maxsize
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self.measurements = 0      # sweep count, for tests/telemetry
        self.hits = 0              # in-memory LRU hits
        self.misses = 0
        self.evictions = 0
        #: seconds per "dataflow|knob=value" candidate of the latest sweep
        self.last_timings: Dict[str, float] = {}

    @property
    def stats(self) -> Dict[str, Any]:
        out = dict(super().stats)
        out.update({"hits": self.hits, "misses": self.misses,
                    "measurements": self.measurements,
                    "evictions": self.evictions,
                    "size": len(self._cache), "maxsize": self.maxsize})
        return out

    def _remember(self, key: tuple, value: Any) -> None:
        self._cache[key] = value
        self._cache.move_to_end(key)
        if self.maxsize is not None and len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
            self.evictions += 1

    @staticmethod
    def _apply_knobs(backend, knobs: Dict[str, Any]) -> None:
        for attr, value in (knobs or {}).items():
            setattr(backend, attr, value)

    def select(self, ctx: SelectionContext) -> str:
        from ..dist.partition import mesh_key   # lazy: dist uses api
        from ..launch.mesh import mesh_placement

        key = (ctx.fingerprint, ctx.backend.name, ctx.block_shape,
               ctx.memory_budget, mesh_key(ctx.mesh),
               mesh_placement(ctx.mesh), ctx.partition,
               str(resolve_device(ctx.device)))
        hit = self._cache.get(key)
        if hit is not None and hit[0] in ctx.allowed:
            self.hits += 1
            self._cache.move_to_end(key)
            self._apply_knobs(ctx.backend, hit[1])
            return hit[0]
        self.misses += 1
        choice, knobs, _ = self._measure(ctx)
        choice, knobs = _first_rank_pick(ctx.mesh, (choice, knobs))
        self._remember(key, (choice, knobs))
        self._apply_knobs(ctx.backend, knobs)
        return choice

    def _synth_operands(self, ctx: SelectionContext):
        m, k = ctx.shape.m, ctx.shape.k
        n = ctx.shape.n
        bm, bk, bn = ctx.block_shape
        seed = int(hashlib.sha1(ctx.fingerprint.encode()).hexdigest()[:8], 16)
        rng = np.random.default_rng(seed)
        a = _values_on_pattern(rng, ctx.occ_a, (m, k), (bm, bk))
        b = _values_on_pattern(rng, ctx.occ_b, (k, n), (bk, bn))
        return a, b

    def _time_plan(self, plan, a, b) -> float:
        """Best of ``reps`` timed applies, in seconds, after one warm-up."""
        a_c, b_c = plan.pack_a(a), plan.pack_b(b)
        plan.apply(a_c, b_c)                        # warm-up
        best = np.inf
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)
            for _ in range(self.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                plan.apply(a_c, b_c)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            return best
        for _ in range(self.reps):
            t0 = time.perf_counter()  # lint: time-ok (measurement)
            plan.apply(a_c, b_c)      # the CPU returns when it is done
            best = min(best, time.perf_counter() - t0)  # lint: time-ok
        return best

    def _measure(self, ctx: SelectionContext
                 ) -> Tuple[str, Dict[str, Any], Dict[str, float]]:
        from .. import obs
        from ..api import flexagon_plan  # lazy: api imports this module

        self.measurements += 1
        obs.get_registry().counter("policy.measurements").inc()
        a, b = self._synth_operands(ctx)
        device = resolve_device(ctx.device)
        # joint (dataflow x backend-knob) sweep: backends with declared
        # tuning knobs get each knob combination measured per dataflow
        knob_space = ctx.backend.tuning_knobs() or {}
        names = sorted(knob_space)
        combos = [dict(zip(names, vals))
                  for vals in itertools.product(*(knob_space[nm]
                                                  for nm in names))] or [{}]
        saved = {nm: getattr(ctx.backend, nm) for nm in names}
        timings: Dict[str, float] = {}
        scored: Dict[Tuple[str, int], float] = {}
        try:
            for ci, combo in enumerate(combos):
                self._apply_knobs(ctx.backend, combo)
                tag = ",".join(f"{nm}={combo[nm]}" for nm in names)
                for d in ctx.allowed:
                    # with a memory budget (or a mesh) the throwaway plan
                    # tiles and shards exactly like the real one, so the
                    # measurement *is* the tiled / sharded execution
                    with obs.span("policy.autotune.measure", dataflow=d,
                                  reps=self.reps) as sp:
                        plan = flexagon_plan(
                            a, b, dataflow=d, block_shape=ctx.block_shape,
                            spec=ctx.spec, backend=ctx.backend,
                            device=device, memory_budget=ctx.memory_budget,
                            mesh=ctx.mesh, partition=ctx.partition,
                            verify=False)
                        best = self._time_plan(plan, a, b)
                        scored[(d, ci)] = best
                        timings[f"{d}|{tag}" if tag else d] = best
                        sp.set(best_s=best)
        finally:
            self._apply_knobs(ctx.backend, saved)
        choice, ci = min(scored, key=lambda dc: (scored[dc], dc))
        self.last_timings = timings
        return choice, combos[ci], timings

    def select_block(self, ctx: SelectionContext,
                     candidates: Tuple[Tuple[int, int, int], ...]
                     ) -> Tuple[int, int, int]:
        """Measure candidate kernel block shapes for this pattern.

        The block-shape analogue of :meth:`select`: synthesizes values on
        the pattern, builds one (policy-default dataflow) plan per
        candidate block shape on the target backend, times ``apply``, and
        returns the fastest — cached in the same LRU.
        """
        from .. import obs
        from ..api import flexagon_plan  # lazy: api imports this module
        from ..dist.partition import mesh_key   # lazy: dist uses api
        from ..launch.mesh import mesh_placement

        candidates = tuple(tuple(c) for c in candidates)
        if not candidates:
            raise ValueError("select_block needs at least one candidate")
        device = resolve_device(ctx.device)
        key = ("block", ctx.fingerprint, ctx.backend.name, candidates,
               ctx.memory_budget, mesh_key(ctx.mesh),
               mesh_placement(ctx.mesh), ctx.partition, str(device))
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            self._cache.move_to_end(key)
            return hit
        self.misses += 1
        self.measurements += 1
        obs.get_registry().counter("policy.measurements").inc()
        a, b = self._synth_operands(ctx)
        timings: Dict[str, float] = {}
        for cand in candidates:
            with obs.span("policy.autotune.measure_block",
                          block=str(cand), reps=self.reps) as sp:
                plan = flexagon_plan(a, b, block_shape=cand, spec=ctx.spec,
                                     backend=ctx.backend, device=device,
                                     memory_budget=ctx.memory_budget,
                                     mesh=ctx.mesh, partition=ctx.partition,
                                     verify=False)
                t = self._time_plan(plan, a, b)
                timings["x".join(map(str, cand))] = t
                sp.set(best_s=t)
        best = min(candidates,
                   key=lambda c: (timings["x".join(map(str, c))], c))
        best = _first_rank_pick(ctx.mesh, best)
        self._remember(key, best)
        return best

    def layer_cost(self, shape: LayerShape, dataflow: str,
                   spec: Optional[DeviceSpec] = None,
                   memory_budget: Optional[Any] = None) -> float:
        # the network DP sees shape features only (no pattern to measure);
        # fall back to the analytical (tiled, if bounded) estimate
        return SelectionPolicy.layer_cost(self, shape, dataflow, spec,
                                          memory_budget)


def _first_rank_pick(mesh, pick):
    """On a process-group mesh every rank measured on its own device, and
    their picks may differ; all take the mesh's first rank's, so that the
    ranks build the same sharded plan.  Elsewhere ``pick`` as it is."""
    from ..launch.mesh import is_process_mesh

    if not is_process_mesh(mesh):
        return pick
    import torch.distributed as dist

    group = mesh.get_group()
    box = [pick]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def _values_on_pattern(rng: np.random.Generator, occ: np.ndarray,
                       shape: Tuple[int, int],
                       block_shape: Tuple[int, int]) -> np.ndarray:
    """Dense values whose block occupancy equals ``occ`` (measurement
    input)."""
    bm, bk = block_shape
    dense = np.zeros((occ.shape[0] * bm, occ.shape[1] * bk), np.float32)
    rows, cols = np.nonzero(occ)
    for r, c in zip(rows, cols):
        dense[r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] = \
            rng.standard_normal((bm, bk)).astype(np.float32) + 0.1
    return dense[: shape[0], : shape[1]]


class FixedPolicy(SelectionPolicy):
    """Always the given dataflow (an explicit ``dataflow=`` pin)."""

    name = "fixed"

    def __init__(self, dataflow: str):
        if dataflow not in df.DATAFLOWS:
            raise ValueError(f"unknown dataflow {dataflow!r}; "
                             f"expected one of {df.DATAFLOWS}")
        self.dataflow = dataflow

    @property
    def cache_key(self) -> str:
        return f"fixed:{self.dataflow}"

    def select(self, ctx: SelectionContext) -> str:
        if self.dataflow not in ctx.allowed:
            raise ValueError(
                f"backend {ctx.backend.name!r} does not support "
                f"{self.dataflow!r} at block_shape={ctx.block_shape}")
        return self.dataflow

    def layer_cost(self, shape: LayerShape, dataflow: str,
                   spec: Optional[DeviceSpec] = None,
                   memory_budget: Optional[Any] = None) -> float:
        return 0.0 if dataflow == self.dataflow else float("inf")


# ---------------------------------------------------------------------------
# Named-policy resolution (singletons, so AutotunePolicy's cache persists)
# ---------------------------------------------------------------------------

_NAMED: Dict[str, SelectionPolicy] = {}


def get_policy(policy: Union[str, SelectionPolicy, None],
               dataflow: str = "auto") -> SelectionPolicy:
    """Resolve ``policy=`` / ``dataflow=`` arguments to one policy instance.

    - an explicit non-"auto" ``dataflow`` pins a :class:`FixedPolicy`
      (and wins over ``policy``);
    - ``dataflow="mixed"`` is *not* a pin: per-tile choices still need a
      pricing policy, so ``policy`` resolves exactly as it would for
      "auto" and the mixed planner calls its ``select_tile`` per tile;
    - ``policy`` may be a name ("heuristic" / "simulator" / "autotune" —
      or a dataflow name, shorthand for a fixed pin) or an instance;
      ``"learned"`` is not ported yet (ROADMAP queue 1, item 11) and raises;
    - neither given → :class:`HeuristicPolicy`.
    """
    if dataflow not in ("auto", "mixed"):
        return FixedPolicy(dataflow)
    if policy is None:
        policy = "heuristic"
    if isinstance(policy, SelectionPolicy):
        return policy
    if policy in df.DATAFLOWS:
        return FixedPolicy(policy)
    if policy == "learned":
        raise NotImplementedError(
            "policy 'learned' is not ported yet (ROADMAP queue 1, item 11); "
            "use 'heuristic', 'simulator', 'autotune' or pin a dataflow")
    if policy not in ("heuristic", "simulator", "autotune"):
        raise KeyError(f"unknown policy {policy!r}; expected "
                       "'heuristic', 'simulator', 'autotune', a dataflow "
                       "name, or a SelectionPolicy instance")
    inst = _NAMED.get(policy)
    if inst is None:
        inst = {"heuristic": HeuristicPolicy,
                "simulator": SimulatorPolicy,
                "autotune": AutotunePolicy}[policy]()
        _NAMED[policy] = inst
    return inst
