"""``reference`` backend — the torch dataflow executors.

Wraps :mod:`repro_torch.core.dataflows`: each of the six dataflows runs
through its torch reference executor on the plan's frozen index plan
(``IPPlan`` / ``StreamPlan``).  ``prepare`` uploads that index plan to the
plan's device once, so repeated applies copy nothing from the host.  This
backend is the numerical oracle the ``cuda`` backend is checked against.
"""
from __future__ import annotations

import torch

from ..core import dataflows as df
from .base import TABLE3_FORMATS, BackendCapability, ExecutionBackend

__all__ = ["ReferenceBackend"]

_EXECUTORS = {
    "ip_m": df.ip_m, "op_m": df.op_m, "gust_m": df.gust_m,
    "ip_n": df.ip_n, "op_n": df.op_n, "gust_n": df.gust_n,
}


class ReferenceBackend(ExecutionBackend):
    name = "reference"
    # the executors drop work entries aimed outside the output grid, so
    # padded OP slab sub-plans (tiled plans) execute as they are
    scan_streaming = True
    schedule_aux_key = None

    def capabilities(self) -> BackendCapability:
        return BackendCapability(
            dataflows=tuple(df.DATAFLOWS),
            formats=tuple(set(TABLE3_FORMATS.values())),
            block_multiple=1,
        )

    def prepare(self, plan):
        return {"index_plan": plan.index_plan.to(plan.device)}

    def execute(self, plan, a, b, out_dtype) -> torch.Tensor:
        out = _EXECUTORS[plan.dataflow](a, b, plan.aux["index_plan"])
        return out.to(out_dtype)
