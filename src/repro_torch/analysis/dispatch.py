"""Dispatch-level report of one ``plan.apply``.

The counterpart of the JAX package's ``repro.analysis.jaxpr``.  JAX traces
``apply`` to a jaxpr and reads purity, cost and identity off it; the port
compiles nothing, so :func:`trace_report` runs one real ``apply`` under a
:class:`torch.utils._python_dispatch.TorchDispatchMode` and records every
aten operator it dispatches:

- **ops** — aten operator names with their counts;
- **host syncs** — the counterpart of JAX's host-callback primitives,
  severity ERROR (``host-sync``): ``aten._local_scalar_dense`` (what
  ``.item()``, ``.tolist()``, ``int(t)`` and ``bool(t)`` dispatch), copies
  from a device to the host, and, on a device, operators whose output
  shape depends on the data (``nonzero``, ``masked_select``, ``unique``,
  ``repeat_interleave`` without ``output_size``, boolean-mask indexing),
  which wait for the device to size their result;
- **kernel launches** — K1/K2/K3/K3w are ctypes calls that the dispatcher does
  not see, so they are read off the wrappers' launch counters
  (``stream_spmm.launches``, ``stream_panel_spmm.launches``,
  ``gmm.launches``, ``gmm_wgrad.launches``) before and after;
- **FLOPs** — from the schedule's real work entries (``2·bm·bk·bn`` per
  entry; the dense escape's padded dense product), against
  ``plan.estimate.flops``, with the reference's 2× ``traffic-disagreement``
  warning;
- **identity** — a hash over the operator sequence with the shapes and
  dtypes of their inputs and outputs.  :class:`RetraceDetector` holds it
  steady across :class:`repro_torch.api.PlanCache` hits: a cached plan
  whose applies dispatch a different program has changed under reuse.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .diagnostics import ERROR, WARNING, PlanDiagnostic

__all__ = ["TraceReport", "trace_report", "RetraceDetector", "Observation"]

#: the operator that reads a tensor's value into the host program
SCALAR_READ = "aten::_local_scalar_dense"
#: operators whose output extent depends on the data: on a device they
#: wait for it to size their result
DATA_DEPENDENT = frozenset({"aten::nonzero", "aten::masked_select",
                            "aten::_unique2", "aten::unique_dim",
                            "aten::unique_consecutive"})


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _on_device(ts) -> bool:
    return any(t.device.type != "cpu" for t in ts)


def _sync_kind(name: str, args, kwargs, outs) -> Optional[str]:
    """Why this operator waits for the device, or ``None``."""
    ins = _tensors(args) + _tensors(kwargs)
    if name == SCALAR_READ:
        return name
    if name in ("aten::_to_copy", "aten::copy_") \
            and _on_device(ins) and outs and not _on_device(outs):
        return "device-to-host copy"
    if not _on_device(ins):
        return None
    if name in DATA_DEPENDENT:
        return name
    if name == "aten::repeat_interleave" \
            and kwargs.get("output_size") is None \
            and any(t.dtype != torch.bool and t.dim() for t in ins):
        return name
    if name in ("aten::index", "aten::index_put_", "aten::index_put") \
            and any(t.dtype == torch.bool for t in ins[1:]):
        return f"{name} (boolean mask)"
    return None


class _Recorder(TorchDispatchMode):
    """Counts every aten operator, and the ones that sync, in order."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.syncs: Counter = Counter()
        self.digest = hashlib.sha1()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        outs = _tensors(out)
        self.ops[name] += 1
        kind = _sync_kind(name, args, kwargs, outs)
        if kind is not None:
            self.syncs[kind] += 1
        sig = (str(func), [(tuple(t.shape), str(t.dtype))
                           for t in _tensors(args) + _tensors(kwargs)],
               [(tuple(t.shape), str(t.dtype)) for t in outs])
        self.digest.update(repr(sig).encode())
        return out


@dataclasses.dataclass(frozen=True)
class TraceReport:
    """What one ``plan.apply`` dispatched."""

    ops: Dict[str, int]               # aten operator -> count
    host_syncs: Dict[str, int]        # why -> count
    launches: Dict[str, int]          # kernel wrapper -> launches
    flops: float                      # schedule work entries, 2·bm·bk·bn
    op_hash: str                      # sha1 over the op sequence
    diagnostics: Tuple[PlanDiagnostic, ...]

    @property
    def pure(self) -> bool:
        """No host sync inside ``apply``."""
        return not self.host_syncs

    @property
    def n_ops(self) -> int:
        return sum(self.ops.values())


def _launch_counts() -> Dict[str, int]:
    from ..kernels import moe_gmm, stream

    return {"stream_spmm": stream.stream_spmm.launches,
            "stream_panel_spmm": stream.stream_panel_spmm.launches,
            "moe_gmm": moe_gmm.gmm.launches,
            "moe_gmm_wgrad": moe_gmm.gmm_wgrad.launches}


def _leaves(plan) -> List[Any]:
    from ..api import FlexagonPlan

    if isinstance(plan, FlexagonPlan):
        return [plan]
    return [leaf for sub in getattr(plan, "plans", ()) for leaf in
            _leaves(sub)]


def _schedule_flops(plan) -> float:
    """FLOPs a plan's applies run, from its schedules: ``2·bm·bk·bn`` per
    real work entry of each leaf plan (its stream schedule, or its index
    plan where the backend keeps none), and the padded dense product for a
    leaf that takes the dense escape.  Summed over tiles and shards."""
    import numpy as np

    from ..core import dataflows as df

    total = 0.0
    for leaf in _leaves(plan):
        m, k, n = leaf.shapes
        bm, bk, bn = leaf.block_shape
        aux = leaf.aux if isinstance(leaf.aux, dict) else {}
        if "dense" in aux:
            total += 2.0 * (-(-m // bm) * bm) * (-(-k // bk) * bk) \
                * (-(-n // bn) * bn)
            continue
        sched = aux.get("stream_schedule")
        if sched is not None:
            work = sched.n_real_work
        elif isinstance(leaf.index_plan, df.IPPlan):
            work = int(np.asarray(leaf.index_plan.npairs).sum())
        else:
            work = int(np.asarray(leaf.index_plan.seg_ptr)[-1])
        total += 2.0 * bm * bk * bn * work
    return total


def trace_report(plan: Any, a: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None,
                 out_dtype=torch.float32) -> TraceReport:
    """Run ``plan.apply`` once under the recorder and report (module doc).

    ``a``/``b`` default to ones of the planned shapes on the plan's device
    (the op sequence depends on the pattern, never on the values)."""
    if not hasattr(plan, "apply") or not hasattr(plan, "shapes"):
        raise TypeError(f"{type(plan).__name__} has no apply to trace; "
                        "trace_report covers FlexagonPlan/TiledPlan/"
                        "ShardedPlan")
    m, k, n = plan.shapes
    if a is None:
        a = torch.ones((m, k), device=plan.device)
    if b is None:
        b = torch.ones((k, n), device=plan.device)
    before = _launch_counts()
    with _Recorder() as rec:
        plan.apply(a, b, out_dtype)
    launches = {name: count - before[name]
                for name, count in _launch_counts().items()}

    diags: List[PlanDiagnostic] = []
    for kind, count in sorted(rec.syncs.items()):
        diags.append(PlanDiagnostic(
            code="host-sync", severity=ERROR,
            message=f"apply makes {count} host sync(s): {kind} — every "
                    "execution waits for the device",
            location="plan.apply",
            hint="phase-2 code must keep values on the device; hoist the "
                 "host work into the planner (phase 1)"))
    flops = _schedule_flops(plan)
    est = getattr(plan, "estimate", None)
    est_flops = float(getattr(est, "flops", 0.0) or 0.0)
    if est_flops > 0 and flops > 0:
        ratio = flops / est_flops
        if ratio > 2.0 or ratio < 0.5:
            diags.append(PlanDiagnostic(
                code="traffic-disagreement", severity=WARNING,
                message=f"the schedules run {flops:.3e} FLOPs but the "
                        f"phase-1 estimate priced {est_flops:.3e} "
                        f"({ratio:.2f}x)",
                location="plan.estimate",
                hint="the selector ranks dataflows off this estimate; "
                     "check memory/traffic.py pricing for this dataflow"))
    return TraceReport(ops=dict(rec.ops), host_syncs=dict(rec.syncs),
                       launches=launches, flops=flops,
                       op_hash=rec.digest.hexdigest(),
                       diagnostics=tuple(diags))


@dataclasses.dataclass(frozen=True)
class Observation:
    """One :class:`RetraceDetector` observation of a plan."""

    key: Tuple[str, str, str]          # (fingerprint, backend, dataflow)
    op_hash: str
    retraced: bool                     # hash changed vs the prior observation


class RetraceDetector:
    """Proves plan reuse never changes what ``apply`` runs.

    Feed it every plan handed out by a :class:`repro_torch.api.PlanCache`;
    two observations of the same (fingerprint, backend, dataflow) with
    different op hashes mean the cached plan's dispatched program changed
    under reuse.
    """

    def __init__(self) -> None:
        self._seen: Dict[Tuple[str, str, str], str] = {}
        self.retraces: List[Observation] = []

    def observe(self, plan: Any, out_dtype=torch.float32) -> Observation:
        key = (plan.fingerprint, plan.backend, plan.dataflow)
        op_hash = trace_report(plan, out_dtype=out_dtype).op_hash
        prev = self._seen.get(key)
        obs = Observation(key=key, op_hash=op_hash,
                          retraced=prev is not None and prev != op_hash)
        self._seen[key] = op_hash
        if obs.retraced:
            self.retraces.append(obs)
        return obs

    @property
    def stable(self) -> bool:
        return not self.retraces
