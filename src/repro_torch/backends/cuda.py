"""``cuda`` backend — the hand-written Hopper kernels behind the plan API.

The counterpart of the JAX package's ``pallas`` backend:

- :meth:`CudaBackend.prepare` lowers the index plan into the kernels'
  phase-1 artifact — a :class:`repro_torch.kernels.StreamSchedule` — once,
  at plan time, and uploads what the kernels read to the plan's device
  (:func:`repro_torch.kernels.device_schedule`), so repeated applies copy
  nothing from the host.  Plans whose effectual block-pair count reaches
  ``dense_threshold`` of the dense work instead carry the dense-escape
  marker: a plain dense product on the densified operands beats sparse
  machinery at high occupancy;
- :meth:`CudaBackend.execute` launches the kernel that
  :meth:`CudaBackend.kernel_call` picks: ``stream_spmm`` (K1) for IP and
  OP, ``stream_panel_spmm`` (K2) for Gustavson.  N-stationary variants run
  through the transpose duality ``C = (Bᵀ Aᵀ)ᵀ``: the block stacks are
  swapped, transposed and made contiguous for the kernels, against
  schedules that phase 1 built for the transposed problem.  An
  M-stationary plan also takes B dense (:meth:`CudaBackend.reads_b_in_place`
  says which B): the kernel then reads B's planned blocks in place, through
  the block coordinates ``prepare`` uploaded, and no gather runs;
- :meth:`CudaBackend.uniform_aux` pads sibling schedules to shared extents.

While tracing is on (:mod:`repro_torch.obs`) an execute names its route on
the caller's ``plan.apply`` span (``k1``, ``k2`` or ``escape``) and runs its
phases under ``plan.apply.dispatch`` (:meth:`CudaBackend.kernel_call`: the
fp32 copies and the N-stationary transposes) and ``plan.apply.launch`` (the
kernel's host checks, zeroed output, launch and cast), or, on the escape,
``plan.apply.escape.densify`` and ``plan.apply.escape.gemm``.

The kernels take any block size, so no block-alignment rule applies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .. import obs
from ..core import dataflows as df
from ..kernels.stream import (BlockCoords, DeviceSchedule, block_coords,
                              device_schedule, pad_schedule, schedule_from_ip,
                              schedule_from_stream, stream_panel_spmm,
                              stream_spmm)
from .base import TABLE3_FORMATS, BackendCapability, ExecutionBackend

__all__ = ["CudaBackend", "KernelCall"]


def _kernel_ready(x):
    """The operand with a contiguous fp32 block stack, as the kernels take."""
    return dataclasses.replace(x, data=x.data.float().contiguous())


class KernelCall(NamedTuple):
    """One stream-kernel launch, as :meth:`CudaBackend.execute` makes it."""

    kernel: Callable            # stream_spmm (K1) or stream_panel_spmm (K2)
    x: Any                      # execution-orientation A, contiguous fp32
    y: Any                      # execution-orientation B, contiguous fp32;
    #                             the dense (K, N) tensor where b_coords is set
    schedule: DeviceSchedule
    transposed: bool            # the launch computes Cᵀ (N-stationary)
    b_coords: BlockCoords = None   # y read in place through these

    @property
    def out_kw(self) -> Dict[str, Any]:
        nb = (self.y.grid if self.b_coords is None else self.b_coords.grid)[1]
        return dict(out_grid=(self.x.grid[0], nb),
                    out_shape=(self.x.shape[0], self.y.shape[1]))

    def run(self, fn: Callable = None, **kw) -> torch.Tensor:
        """``fn`` (default: the kernel) on this launch's inputs."""
        if self.b_coords is None:
            y = self.y.data
        else:
            y, kw["b_coords"] = self.y, self.b_coords
        return (fn or self.kernel)(self.x.data, y, self.schedule,
                                   **self.out_kw, **kw)


class CudaBackend(ExecutionBackend):
    name = "cuda"
    # the kernels drop pad runs aimed one past the output grid, so padded
    # OP slab sub-plans (tiled plans) and padded lanes execute as they are
    scan_streaming = True
    # registers every cuda plan with the static schedule checker
    # (repro_torch.analysis.schedule): verify_plan proves the schedule's
    # invariants, and audits the device tables K1/K2 read, before anything
    # executes it
    schedule_aux_key = "stream_schedule"

    def __init__(self, dense_threshold: float = 0.5):
        #: occupancy escape hatch: when a plan's effectual block-pair count
        #: reaches this fraction of the dense block-pair count, run a plain
        #: dense product instead of the sparse kernel (>= 1.0 keeps every
        #: plan sparse)
        self.dense_threshold = float(dense_threshold)

    def capabilities(self) -> BackendCapability:
        return BackendCapability(
            dataflows=tuple(df.DATAFLOWS),
            formats=tuple(set(TABLE3_FORMATS.values())),
            block_multiple=1,
        )

    def tuning_knobs(self) -> Dict[str, Tuple[Any, ...]]:
        # 2.0 disables the escape hatch (the ratio never exceeds 1.0)
        return {"dense_threshold": (0.25, 0.5, 2.0)}

    # -- phase 1 ---------------------------------------------------------
    def _work_ratio(self, plan) -> float:
        """Effectual block pairs as a fraction of the dense pair count."""
        ip = plan.index_plan
        if isinstance(ip, df.IPPlan):
            w = int(ip.npairs.sum())
        else:
            w = int(ip.seg_ptr[-1])
        m, k, n = plan.shapes
        bm, bk, bn = plan.block_shape
        dense = (math.ceil(m / bm) * math.ceil(k / bk) * math.ceil(n / bn))
        return w / max(dense, 1)

    def prepare(self, plan) -> Dict[str, Any]:
        """Lower the index plan to the kernels' work list, upload it once.

        N-stationary schedules are built for the transposed problem,
        matching how :meth:`execute` runs them.  M-stationary plans also
        carry B's block coordinates (``"b_coords"``), through which the
        kernels read a dense B in place.  High-occupancy plans also carry
        the dense-escape marker (``"dense"``).
        """
        base = plan.dataflow[:-2]
        if base == "ip":
            sched = schedule_from_ip(plan.index_plan)
        else:
            sched = schedule_from_stream(plan.index_plan,
                                         by_dest=(base == "op"))
        aux: Dict[str, Any] = {
            "stream_schedule": sched,
            "device_schedule": device_schedule(sched, plan.device),
        }
        if not plan.dataflow.endswith("_n"):
            lay = plan.b_layout
            aux["b_coords"] = block_coords(lay.rows, lay.cols, lay.shape,
                                           lay.block_shape, plan.device)
        if self._work_ratio(plan) >= self.dense_threshold:
            aux["dense"] = ()
        return aux

    def uniform_aux(self, plans) -> None:
        """Pad sibling schedules to shared (work, run) extents, in place.

        Also demotes a mixed dense/sparse group to all-sparse, so the
        members agree on how they execute.
        """
        plans = [p for p in plans
                 if isinstance(getattr(p, "aux", None), dict)
                 and "stream_schedule" in p.aux]
        if len(plans) < 2:
            return
        if not all("dense" in p.aux for p in plans):
            for p in plans:
                p.aux.pop("dense", None)
        scheds = [p.aux["stream_schedule"] for p in plans]
        w_max = max(s.n_work for s in scheds)
        r_total = max(s.n_runs for s in scheds) + 1
        for p, s in zip(plans, scheds):
            m, _, n = p.shapes
            bm, _, bn = p.block_shape
            # pad runs target one past the *execution-orientation* output
            # grid's row count (the transposed grid for N-stationary)
            oob_row = (math.ceil(n / bn) if p.dataflow.endswith("_n")
                       else math.ceil(m / bm))
            padded = pad_schedule(s, w_max, r_total, oob_row)
            p.aux["stream_schedule"] = padded
            p.aux["device_schedule"] = device_schedule(padded, p.device)

    # -- phase 2 ---------------------------------------------------------
    def _densify(self, x, layout) -> torch.Tensor:
        """Dense image of a compressed operand via its layout's scatter."""
        bm, bk = layout.block_shape
        gr = math.ceil(layout.shape[0] / bm)
        gc = math.ceil(layout.shape[1] / bk)
        canvas = torch.zeros((gr, gc, bm, bk), dtype=x.data.dtype,
                             device=x.data.device)
        canvas[layout.rows_t, layout.cols_t] = x.data
        return canvas.transpose(1, 2).reshape(gr * bm, gc * bk)

    def _execute_dense(self, plan, a, b, out_dtype) -> torch.Tensor:
        m, _, n = plan.shapes
        with obs.span("plan.apply.escape.densify"):
            a_d = self._densify(a, plan.a_layout).float()
            b_d = self._densify(b, plan.b_layout).float()
        with obs.span("plan.apply.escape.gemm"):
            return torch.matmul(a_d, b_d)[:m, :n].to(out_dtype)

    def reads_b_in_place(self, plan, b) -> bool:
        """Can :meth:`execute` take this ``b`` dense, its planned blocks
        read in place by the kernel?  So for an M-stationary plan off the
        dense escape and a plain fp32 ``(K, N)`` tensor on the plan's
        device with unit column stride; every other B is gathered."""
        coords = plan.aux.get("b_coords")
        return (coords is not None and "dense" not in plan.aux
                and type(b) is torch.Tensor and b.dtype == torch.float32
                and b.device == coords.rows.device
                and tuple(b.shape) == coords.shape and b.stride(1) == 1
                and 0 < b.stride(0) < 2 ** 31)

    def kernel_call(self, plan, a, b) -> KernelCall:
        """The kernel, operands and schedule :meth:`execute` launches for a
        sparse (not dense-escape) ``plan`` on compressed ``a`` and ``b``
        compressed, or dense where :meth:`reads_b_in_place` took it."""
        base = plan.dataflow[:-2]
        kernel = stream_panel_spmm if base == "gust" else stream_spmm
        sched = plan.aux["device_schedule"]
        if not plan.dataflow.endswith("_n"):
            if isinstance(b, torch.Tensor):
                return KernelCall(kernel, _kernel_ready(a), b, sched, False,
                                  plan.aux["b_coords"])
            return KernelCall(kernel, _kernel_ready(a), _kernel_ready(b),
                              sched, False)
        # transpose duality: C = (Bᵀ Aᵀ)ᵀ, on schedules built transposed
        tr_a, tr_b = {"ip": (df._transpose_bcsc_of, df._transpose_bcsr_of),
                      "op": (df._transpose_bcsr_of, df._transpose_bcsc_of),
                      "gust": (df._transpose_bcsr_of, df._transpose_bcsr_of),
                      }[base]
        return KernelCall(kernel, _kernel_ready(tr_b(b)),
                          _kernel_ready(tr_a(a)), sched, True)

    def execute(self, plan, a, b, out_dtype) -> torch.Tensor:
        if "dense" in plan.aux:
            # occupancy escape hatch: orientation-independent dense product
            obs.annotate(route="escape")
            return self._execute_dense(plan, a, b, out_dtype)
        with obs.span("plan.apply.dispatch"):
            call = self.kernel_call(plan, a, b)
        obs.annotate(route="k2" if call.kernel is stream_panel_spmm else "k1")
        with obs.span("plan.apply.launch"):
            out = call.run(out_dtype=out_dtype)
        return out.T if call.transposed else out
