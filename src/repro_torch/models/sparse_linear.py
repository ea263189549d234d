"""Compressed sparse-FFN inference — the paper's technique end-to-end in a
model.

Training keeps block-masked dense weights; for serving, this module runs
phase 1 *once* per (token count, layer) through the plan API:

- phase 1: :func:`compress_ffn` — builds :class:`repro_torch.api.
  FlexagonPlan`\\ s for the FFN's three matmuls (occupancy → selector →
  compression layout → index plans → device work lists) and packs the
  weights into the planned formats;
- runtime: :func:`sparse_ffn_apply` — plain ``plan.apply`` calls, zero
  host-side re-planning.  A decode loop that admits new token shapes gets
  a shape-specialized plan from the per-FFN cache
  (:meth:`CompressedFFN.specialize`), built at admission and reused every
  subsequent step.

The activations-side operand is dense here (weights sparse × activations
dense), the SpMM special case of SpMSpM — ``flexagon_plan`` takes the bare
``(tokens, d)`` shape as a fully-dense pattern.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from ..api import (PlanCache, SparseOperand, _refuse_unported,
                   _resolve_plan_device)
from ..core.selector import DeviceSpec
from .ffn import _masked_weight

__all__ = ["CompressedFFN", "PlannedFFN", "compress_ffn", "sparse_ffn_apply"]


@dataclasses.dataclass(frozen=True)
class PlannedFFN:
    """Plans + packed weights for one token shape (phase-1 output)."""

    plan_in: Any                 # x @ w_gate and x @ w_up  (same pattern)
    plan_out: Any                # h @ w_down; Flexagon-, Tiled- or ShardedPlan
    w_gate: SparseOperand
    w_up: SparseOperand
    w_down: SparseOperand


class CompressedFFN(torch.nn.Module):
    """One pruned FFN, planned per token shape and cached.

    ``specialize(tokens)`` is the admission-time hook: the first request for
    a token shape runs phase 1 (counted in ``plan_builds``); every subsequent
    request is a dictionary hit (``plan_hits``) — the plan-once /
    execute-many contract for serving loops.

    The masked dense weights are kept as (non-trainable) buffers for
    phase 1 only; execution reads the packed block stacks.  The plans route
    through a (shareable, LRU-bounded) :class:`repro_torch.api.PlanCache`;
    ``max_shapes`` bounds the per-token-shape entries the FFN itself keeps.
    """

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, *, tokens: int, block: int = 128,
                 spec: DeviceSpec = DeviceSpec(), backend=None, policy=None,
                 device=None, memory_budget=None, mesh=None, partition=None,
                 plan_cache: Optional[PlanCache] = None,
                 max_shapes: Optional[int] = None,
                 verify: Optional[bool] = None):
        super().__init__()
        self.device = _resolve_plan_device(device, mesh)
        self.register_buffer("w_gate_dense", w_gate.to(self.device))
        self.register_buffer("w_up_dense", w_up.to(self.device))
        self.register_buffer("w_down_dense", w_down.to(self.device))
        self.block = block
        self.spec = spec
        self.backend = backend                  # registry name / instance
        self.policy = policy                    # SelectionPolicy / name
        self.memory_budget = memory_budget      # repro_torch.memory budget
        self.mesh = mesh                        # repro_torch.launch.mesh
        self.partition = partition              # repro_torch.dist partition
        self.verify = verify                    # plan-build verification gate
        self.tokens = tokens
        self.plan_cache = plan_cache if plan_cache is not None \
            else PlanCache(spec, maxsize=None if max_shapes is None
                           else 2 * max_shapes)
        self.max_shapes = max_shapes
        self._by_tokens: "OrderedDict[int, PlannedFFN]" = OrderedDict()
        self.shape_evictions = 0
        # packed weights are keyed by ("gate"|"up"|"down", planned B format):
        # the weight-side layout depends only on the weight pattern and the
        # format Table 3 assigns, so token shapes sharing a dataflow family
        # share one packed copy instead of one per token count
        self._packed: Dict[tuple, SparseOperand] = {}
        self.plan_builds = 0
        self.plan_hits = 0
        self.specialize(tokens)

    @property
    def cache_stats(self) -> Dict[str, Any]:
        """Plan-cache counters + this FFN's shape-level cache state."""
        stats = dict(self.plan_cache.stats)
        stats["shapes"] = len(self._by_tokens)
        stats["shape_evictions"] = self.shape_evictions
        return stats

    def _pack(self, which: str, w: torch.Tensor, plan) -> SparseOperand:
        key = (which, plan.formats[1])
        packed = self._packed.get(key)
        if packed is None:
            packed = plan.pack_b(w)
            self._packed[key] = packed
        return packed

    def specialize(self, tokens: int) -> PlannedFFN:
        """Plans for this token count — built once, then cache hits."""
        entry = self._by_tokens.get(tokens)
        if entry is not None:
            self.plan_hits += 1
            self._by_tokens.move_to_end(tokens)
            return entry
        wg, wu, wd = self.w_gate_dense, self.w_up_dense, self.w_down_dense
        d, f = wg.shape
        bs = (self.block, self.block, self.block)
        kw = dict(block_shape=bs, backend=self.backend, policy=self.policy,
                  device=self.device, memory_budget=self.memory_budget,
                  mesh=self.mesh, partition=self.partition,
                  verify=self.verify)
        plan_in = self.plan_cache.get((tokens, d), wg, **kw)
        plan_out = self.plan_cache.get((tokens, f), wd, **kw)
        entry = PlannedFFN(plan_in, plan_out,
                           self._pack("gate", wg, plan_in),
                           self._pack("up", wu, plan_in),
                           self._pack("down", wd, plan_out))
        self._by_tokens[tokens] = entry
        self.plan_builds += 1
        if self.max_shapes is not None \
                and len(self._by_tokens) > self.max_shapes:
            self._by_tokens.popitem(last=False)
            self.shape_evictions += 1
        return entry

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sparse_ffn_apply(self, x)

    # -- conveniences over the default (construction-time) token shape ----
    @property
    def _default(self) -> PlannedFFN:
        entry = self._by_tokens.get(self.tokens)
        if entry is None:               # evicted under max_shapes: replan
            entry = self.specialize(self.tokens)
        return entry

    @property
    def w_gate(self) -> SparseOperand:
        return self._default.w_gate

    @property
    def w_up(self) -> SparseOperand:
        return self._default.w_up

    @property
    def w_down(self) -> SparseOperand:
        return self._default.w_down

    @property
    def dataflow_in(self) -> str:
        return self._default.plan_in.dataflow

    @property
    def dataflow_out(self) -> str:
        return self._default.plan_out.dataflow


def compress_ffn(ffn_params: Dict[str, Any], *, tokens: int,
                 block: int = 128, spec: DeviceSpec = DeviceSpec(),
                 backend=None, policy=None, device=None,
                 memory_budget=None, mesh=None, partition=None,
                 plan_cache: Optional[PlanCache] = None,
                 max_shapes: Optional[int] = None,
                 verify: Optional[bool] = None) -> CompressedFFN:
    """Phase 1 for one pruned FFN layer: occupancy → dataflow → plans.

    ``ffn_params`` is ``{"w_gate": {"w"}, "w_up": {"w"}, "w_down": {"w"},
    "block_mask"}`` of tensors (see :func:`repro_torch.convert.
    ffn_params_from_jax`).  ``backend``/``policy`` parameterize the plan
    API's execution substrate and selection strategy; ``device=None``
    resolves to the card.  ``memory_budget`` auto-tiles over-budget
    matmuls (see :mod:`repro_torch.memory`).  ``mesh``/``partition`` shard
    every matmul's plan across a mesh (see :mod:`repro_torch.dist`).
    ``verify=True`` (also through ``REPRO_VERIFY=1``) is not ported yet and
    raises.
    """
    _refuse_unported(verify)
    if "block_mask" not in ffn_params:
        raise ValueError("FFN is not block-pruned (no 'block_mask')")
    dev = _resolve_plan_device(device, mesh)
    mask = torch.as_tensor(ffn_params["block_mask"], device=dev)

    def masked(name, m):
        return _masked_weight(
            torch.as_tensor(ffn_params[name]["w"], device=dev), m)

    return CompressedFFN(masked("w_gate", mask), masked("w_up", mask),
                         masked("w_down", mask.T), tokens=tokens,
                         block=block, spec=spec, backend=backend,
                         policy=policy, device=dev,
                         memory_budget=memory_budget, mesh=mesh,
                         partition=partition, plan_cache=plan_cache,
                         max_shapes=max_shapes, verify=verify)


def sparse_ffn_apply(comp: CompressedFFN, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) via the compressed, dataflow-planned FFN."""
    b, s, d = x.shape
    entry = comp.specialize(b * s)          # cache hit on steady-state shapes
    x2d = x.reshape(b * s, d).float()
    g = torch.nn.functional.silu(entry.plan_in.apply(x2d, entry.w_gate))
    u = entry.plan_in.apply(x2d, entry.w_up)
    y = entry.plan_out.apply(g * u, entry.w_down)
    return y.reshape(b, s, d).to(x.dtype)
