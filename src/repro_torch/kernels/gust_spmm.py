"""Gustavson (MKN) SpMSpM on the row-panel kernel.

The paper's Gust dataflow (§3.2.3): the **output row panel is stationary**
and each nonzero element of A's row fiber (the leader) gathers B's entire
matching row fiber (the follower).  The effectual pairs are enumerated at
plan time into an i-major work list, and psums merge *immediately* into the
current row panel at the follower's column
(:func:`repro_torch.kernels.stream.stream_panel_spmm`), so C is written
once.  A ``bm × N × 4``-byte panel exceeds a CUDA block's shared memory at
modest N, so the kernel tiles each panel by column blocks.
"""
from __future__ import annotations

import torch

from ..core.dataflows import StreamPlan, build_gust_plan
from ..core.formats import BlockCSR
from .stream import (DeviceSchedule, StreamSchedule, device_schedule,
                     schedule_from_stream, stream_panel_spmm)

__all__ = ["gust_spmm"]


def gust_spmm(a: BlockCSR, b: BlockCSR, plan: StreamPlan | None = None, *,
              schedule: StreamSchedule | DeviceSchedule | None = None,
              out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B via Gustavson's dataflow.  Returns dense C (M, N).

    ``schedule`` (from :func:`schedule_from_stream` with ``by_dest=False``)
    carries the i-major work list; omitted, it is rebuilt on the host.
    """
    if a.nnzb == 0 or b.nnzb == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=out_dtype,
                           device=a.data.device)
    if schedule is None:
        if plan is None:
            plan = build_gust_plan(a, b)  # lint: host-ok (concrete-only fallback)
        schedule = schedule_from_stream(plan, by_dest=False)  # lint: host-ok (concrete-only fallback)
    if not isinstance(schedule, DeviceSchedule):
        schedule = device_schedule(schedule, a.data.device)  # lint: host-ok (one-shot call)
    return stream_panel_spmm(a.data, b.data, schedule,
                             out_grid=(a.grid[0], b.grid[1]),
                             out_shape=(a.shape[0], b.shape[1]),
                             out_dtype=out_dtype)
