"""Inner-Product (MNK) SpMSpM on the block-run kernel.

The paper's IP dataflow (§3.2.1): the K co-iteration walks the
*intersection* of A's row fiber and B's column fiber, computed at plan time
on the host, so only effectual block pairs are ever fetched.  The
intersection lists are already destination-major (i, j, p), so they lower
directly onto :func:`repro_torch.kernels.stream.stream_spmm`: each C block
is one run, summed in one CUDA block and written once — no partial sums
leave it.
"""
from __future__ import annotations

import torch

from ..core.dataflows import IPPlan, build_ip_plan
from ..core.formats import BlockCSR, BlockCSC
from .stream import (DeviceSchedule, StreamSchedule, device_schedule,
                     schedule_from_ip, stream_spmm)

__all__ = ["ip_spmm"]


def ip_spmm(a: BlockCSR, b: BlockCSC, plan: IPPlan | None = None, *,
            schedule: StreamSchedule | DeviceSchedule | None = None,
            out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B via the Inner-Product dataflow.  Returns dense C (M, N).

    ``schedule`` carries the phase-1 work list; omitted, it is rebuilt on
    the host from ``plan`` (itself rebuilt from the operand structure when
    omitted).
    """
    if a.nnzb == 0 or b.nnzb == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=out_dtype,
                           device=a.data.device)
    if schedule is None:
        if plan is None:
            plan = build_ip_plan(a, b)  # lint: host-ok (concrete-only fallback)
        schedule = schedule_from_ip(plan)  # lint: host-ok (concrete-only fallback)
    if not isinstance(schedule, DeviceSchedule):
        schedule = device_schedule(schedule, a.data.device)  # lint: host-ok (one-shot call)
    return stream_spmm(a.data, b.data, schedule,
                       out_grid=(a.grid[0], b.grid[1]),
                       out_shape=(a.shape[0], b.shape[1]),
                       out_dtype=out_dtype)
