"""Serving engine: batched prefill/decode with continuous batching.

The port of ``repro.serve.engine``.  Slot-based design (vLLM-lite): the
engine owns a fixed-batch KV cache; each slot holds one in-flight request.
New requests prefill into a free slot (a batch-1 prefill written into the
slot's cache lines); every :meth:`ServeEngine.step` runs one fused decode
for all active slots; finished sequences free their slot for queued
requests.  Greedy sampling.

Phase 1 runs at admission, not per step:

- an MoE model whose config says ``strategy="auto"`` gets its dispatch
  strategy planned once for the fused decode shape
  (:func:`repro_torch.models.moe.plan_moe`), and decode runs a model whose
  config pins that strategy.  Prefill keeps the unpinned model (its shapes
  vary per prompt).
- a pruned-FFN model passes its :class:`repro_torch.models.sparse_linear
  .CompressedFFN`; the engine specializes it for the fused decode shape at
  construction (``decode_ffn``) and for each new prefill length at
  admission (``stats["plan_builds"]`` / ``stats["plan_hits"]``).

JAX's ``jax.jit`` of the decode closure has no counterpart: the port runs
eagerly.  The model writes the cache tensors in place, so the engine holds
exactly one cache.  Telemetry goes through :mod:`repro_torch.obs`: each
engine owns a :class:`~repro_torch.obs.MetricsRegistry`
(``serve.prefills`` / ``decode_steps`` / ``completed`` counters and
``serve.latency.{queue_s,prefill_s,decode_step_s,request_s}``
histograms, summarized by :meth:`ServeEngine.latency_stats`).  The decode
step's latency is taken after the step's logits reach the host, so it
covers the device's work.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..models.moe import MoEPlan, plan_moe

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) integer token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    # obs bookkeeping (admit→complete span + queue/request latency)
    t_submit_ns: Optional[int] = None
    t_admit_ns: Optional[int] = None
    span_id: Optional[int] = None

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.out_tokens \
                and self.out_tokens[-1] == self.eos_id:
            return True
        return len(self.out_tokens) >= self.max_new_tokens


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 4, max_seq: int = 256,
                 dtype=torch.bfloat16, sparse_ffn=None, moe_policy=None,
                 verify: Optional[bool] = None):
        self.model = model
        if sparse_ffn is not None and verify is not None:
            sparse_ffn.verify = verify
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        # prefill builds its batch-1 caches with the engine's dtype, so
        # prefill compute and the slot write agree
        self.dtype = dtype
        self.cache = model.init_cache(slots, max_seq, dtype)
        self._free = deque(range(slots))
        self._active: Dict[int, Request] = {}
        self._queue: deque = deque()
        self._finished: List[Request] = []
        self._positions = np.zeros(slots, np.int64)
        self.metrics = obs.MetricsRegistry()
        self._plan_stats: Dict[str, Any] = {"plan_builds": 0, "plan_hits": 0}
        # phase 1 for the steady state, up front: the fused decode step
        # always runs `slots` tokens, so its plans never change after this
        self.sparse_ffn = sparse_ffn
        self.decode_ffn = None
        if sparse_ffn is not None:
            self.decode_ffn = sparse_ffn.specialize(slots)
        self.moe_plan: Optional[MoEPlan] = None
        decode_model = model
        cfg = getattr(model, "cfg", None)
        if cfg is not None and getattr(cfg, "moe", None) is not None \
                and cfg.moe.strategy == "auto":
            self.moe_plan = plan_moe(cfg, slots, policy=moe_policy)
            pinned = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe,
                                             strategy=self.moe_plan.strategy))
            decode_model = dataclasses.replace(model, cfg=pinned)
        self._decode = decode_model.decode_step
        self._sync_plan_stats()

    @property
    def stats(self) -> Dict[str, Any]:
        """Point-in-time telemetry snapshot; every call is a deep copy."""
        m = self.metrics
        out: Dict[str, Any] = {
            "prefills": int(m.value("serve.prefills")),
            "decode_steps": int(m.value("serve.decode_steps")),
            "completed": int(m.value("serve.completed")),
        }
        out.update(copy.deepcopy(self._plan_stats))
        return out

    def latency_stats(self) -> Dict[str, Dict[str, Any]]:
        """``serve.latency.*`` histogram summaries (count/p50/p90/p99)."""
        return self.metrics.snapshot(prefix="serve.latency.")

    def verify_plans(self) -> List[Any]:
        """Audit every plan currently cached for serving.

        Runs :func:`repro_torch.analysis.verify_cache` — the full plan
        invariants *plus* the static schedule checker and the device-table
        audit — over the sparse FFN's LRU as it stands now, so a serving
        loop can prove that re-admitted/re-targeted entries (not just
        original insertions) still carry race-free, in-bounds,
        deterministic schedules.  Returns the diagnostics ([] for engines
        without a sparse FFN).
        """
        if self.sparse_ffn is None:
            return []
        from ..analysis import verify_cache

        return list(verify_cache(self.sparse_ffn.plan_cache))

    def _sync_plan_stats(self):
        if self.sparse_ffn is None:
            return
        ps = self._plan_stats
        ps["plan_builds"] = self.sparse_ffn.plan_builds
        ps["plan_hits"] = self.sparse_ffn.plan_hits
        backend = self.sparse_ffn.backend
        ps["backend"] = (backend if isinstance(backend, str)
                         else getattr(backend, "name", None)) or "reference"
        ps["plan_cache"] = copy.deepcopy(self.sparse_ffn.cache_stats)
        # selection-policy telemetry (autotune hit/miss/measurement
        # counters), deep-copied: the policy owns the live dict
        pol = self.sparse_ffn.policy
        if pol is not None:
            pol_stats = getattr(pol, "stats", None)
            ps["policy"] = (copy.deepcopy(pol_stats)
                            if isinstance(pol_stats, dict)
                            else {"name": str(pol)})
        # sharded fused decode: shard / collective telemetry from the
        # decode-shape plans
        entry = self.decode_ffn
        if entry is not None:
            dist = [p.dist_stats for p in (entry.plan_in, entry.plan_out)
                    if hasattr(p, "dist_stats")]
            if dist:
                ici = float(sum(d["ici_bytes"] for d in dist))
                ps["dist"] = {
                    "mesh_shape": dist[0]["mesh_shape"],
                    "shards": dist[0]["shards"],
                    "collectives": sum(1 for d in dist
                                       if d["collective"] == "psum"),
                    "ici_bytes": ici,
                }
                obs.get_registry().gauge("dist.ici_bytes").set(ici)

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request):
        req.t_submit_ns = obs.now_ns()
        self._queue.append(req)
        self._admit()

    def _admit(self):
        while self._queue and self._free:
            req = self._queue.popleft()
            slot = self._free.popleft()
            req.slot = slot
            req.t_admit_ns = obs.now_ns()
            if req.t_submit_ns is not None:
                self.metrics.histogram("serve.latency.queue_s").observe(
                    (req.t_admit_ns - req.t_submit_ns) / 1e9)
            if obs.enabled():
                req.span_id = obs.get_tracer().new_id()
            self._prefill_into_slot(req)
            self._active[slot] = req

    def _prefill_into_slot(self, req: Request):
        """Batch-1 prefill, written into this slot's cache lines."""
        t0 = obs.now_ns()
        if self.sparse_ffn is not None:
            self.sparse_ffn.specialize(len(req.prompt))
            self._sync_plan_stats()
        one_cache = self.model.init_cache(1, self.max_seq, self.dtype)
        tokens = np.asarray(req.prompt, np.int64)[None]
        logits, one_cache = self.model.prefill(self.params, tokens, one_cache)
        req.out_tokens.append(int(torch.argmax(logits[0, -1])))
        self._write_slot(req.slot, one_cache)
        self._set_pos(req.slot, len(req.prompt))
        dur = obs.now_ns() - t0
        if req.span_id is not None:
            obs.get_tracer().record(
                "serve.prefill", t0, dur, parent=req.span_id,
                attrs={"rid": req.rid, "slot": req.slot,
                       "prompt_len": len(req.prompt)})
        self.metrics.counter("serve.prefills").inc()
        self.metrics.histogram("serve.latency.prefill_s").observe(dur / 1e9)

    def _write_slot(self, slot: int, one_cache, replace_full: bool = True):
        """Copy every leaf of a batch-1 cache into this slot's cache lines.

        An unmatched non-scalar leaf is a hard error: skipping the write
        would leave the slot decoding against a stale prefix.
        ``replace_full=False`` leaves shape-identical leaves untouched (a
        leaf with the same shape at batch 1 and batch ``slots`` is
        slot-independent, and a slot reset must not clobber it).
        """

        def write(full: torch.Tensor, one: torch.Tensor):
            if one.dim() == 0:
                return
            if one.shape == full.shape:      # slots == 1: replace outright
                if replace_full:
                    full.copy_(one)
                return
            # batch dim = the unique dim where full is `slots` wide and the
            # batch-1 cache is 1 wide, with all other dims matching
            cands = [d for d in range(full.dim())
                     if full.shape[d] == self.slots and one.shape[d] == 1
                     and full.shape[:d] == one.shape[:d]
                     and full.shape[d + 1:] == one.shape[d + 1:]]
            if not cands:
                raise ValueError(
                    f"cannot locate the batch dim of cache leaf with shape "
                    f"{tuple(one.shape)} against slot cache leaf "
                    f"{tuple(full.shape)} (slots={self.slots}); refusing to "
                    "skip the write — the slot would decode against a "
                    "stale prefix")
            full.select(cands[0], slot).copy_(one.squeeze(cands[0]))

        for full_layer, one_layer in zip(self.cache["layers"],
                                         one_cache["layers"]):
            for name, full in full_layer.items():
                write(full, one_layer[name])

    def _set_pos(self, slot: int, value: int):
        self.cache["pos"][slot] = value
        self._positions[slot] = value

    def _reset_slot(self, slot: int):
        """Return a freed slot to the zero state: cache lines and ``pos``."""
        self._write_slot(slot, self.model.init_cache(1, self.max_seq,
                                                     self.dtype),
                         replace_full=self.slots == 1)
        self._set_pos(slot, 0)

    def _complete_request(self, req: Request):
        """Close out a finished request's telemetry (admit→complete)."""
        t_end = obs.now_ns()
        if req.t_admit_ns is not None:
            self.metrics.histogram("serve.latency.request_s").observe(
                (t_end - req.t_admit_ns) / 1e9)
        if req.span_id is not None:
            obs.get_tracer().record(
                "serve.request", req.t_admit_ns, t_end - req.t_admit_ns,
                sid=req.span_id,
                attrs={"rid": req.rid, "slot": req.slot,
                       "prompt_len": len(req.prompt),
                       "new_tokens": len(req.out_tokens)})

    # -- decode loop -----------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One fused decode for all active slots; returns (rid, token) pairs."""
        if not self._active:
            return []
        t0 = obs.now_ns()
        toks = np.zeros((self.slots, 1), np.int64)
        for slot, req in self._active.items():
            toks[slot, 0] = req.out_tokens[-1]
        # per-slot positions: mixed-progress slots decode correctly in one
        # fused step — continuous batching
        with obs.span("serve.decode_step", active=len(self._active)):
            logits, self.cache = self._decode(self.params, self.cache, toks)
            nxt_all = torch.argmax(logits[:, -1], dim=-1).tolist()
        self.metrics.counter("serve.decode_steps").inc()
        self.metrics.histogram("serve.latency.decode_step_s").observe(
            (obs.now_ns() - t0) / 1e9)
        out = []
        finished = []
        for slot, req in list(self._active.items()):
            nxt = int(nxt_all[slot])
            req.out_tokens.append(nxt)
            self._positions[slot] += 1
            out.append((req.rid, nxt))
            if req.done:
                finished.append(slot)
        for slot in finished:
            self.metrics.counter("serve.completed").inc()
            req = self._active.pop(slot)
            self._complete_request(req)
            self._finished.append(req)
            self._free.append(slot)
            self._reset_slot(slot)
        # free slots rode the fused step too (the batch shape is fixed);
        # undo the pos side effect so an idle slot's state cannot drift
        if len(self._active) < self.slots:
            active = torch.zeros(self.slots, dtype=torch.bool,
                                 device=self.cache["pos"].device)
            active[list(self._active)] = True
            self.cache["pos"] = torch.where(
                active, self.cache["pos"],
                torch.zeros_like(self.cache["pos"]))
        self._admit()
        return out

    def run_to_completion(self, max_steps: int = 1024
                          ) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}

        def harvest():
            for req in self._finished:
                results[req.rid] = req.out_tokens
            self._finished.clear()

        for _ in range(max_steps):
            if not self._active and not self._queue:
                break
            self.step()
            harvest()
        harvest()
        for req in list(self._active.values()):
            results[req.rid] = req.out_tokens
        return results
