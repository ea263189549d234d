"""Outer-Product (KMN) SpMSpM on the block-run kernel — fused stream + merge.

The paper's OP dataflow (§3.2.2) runs a **streaming phase** producing psum
fibers, then a **merging phase** combining them row by row through the MRN.
Here both phases are one kernel: the k-major psum work list is
**destination-lexsorted at plan time** — the host sort plays the PSRAM's
set/tag lookup — after which the stream arrives merge-ready and each run
accumulates one output block in registers.  OP's psum traffic is thereby
paid at plan time (the sort), not as a round trip through device memory.
"""
from __future__ import annotations

import torch

from ..core.dataflows import StreamPlan, build_op_plan
from ..core.formats import BlockCSR, BlockCSC
from .stream import (DeviceSchedule, StreamSchedule, device_schedule,
                     schedule_from_stream, stream_spmm)

__all__ = ["op_spmm"]


def op_spmm(a: BlockCSC, b: BlockCSR, plan: StreamPlan | None = None, *,
            schedule: StreamSchedule | DeviceSchedule | None = None,
            out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B via the Outer-Product dataflow.  Returns dense C (M, N).

    ``schedule`` (from :func:`schedule_from_stream` with ``by_dest=True``)
    carries the destination-sorted work list; omitted, it is rebuilt on
    the host.
    """
    if a.nnzb == 0 or b.nnzb == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=out_dtype,
                           device=a.data.device)
    if schedule is None:
        if plan is None:
            plan = build_op_plan(a, b)  # lint: host-ok (concrete-only fallback)
        schedule = schedule_from_stream(plan, by_dest=True)  # lint: host-ok (concrete-only fallback)
    if not isinstance(schedule, DeviceSchedule):
        schedule = device_schedule(schedule, a.data.device)  # lint: host-ok (one-shot call)
    return stream_spmm(a.data, b.data, schedule,
                       out_grid=(a.grid[0], b.grid[1]),
                       out_shape=(a.shape[0], b.shape[1]),
                       out_dtype=out_dtype)
