"""Dataflow selection — the paper's offline mapper/compiler (phase 1).

Given an SpMSpM operation's features (dimensions, sparsity degrees, block
occupancy) and a hardware description, estimate per-dataflow execution time
and pick the best.  :class:`DeviceSpec` is the hardware description: its
default instance is the NVIDIA H100 SXM the port runs on (roofline-style
max(compute, memory) over the traffic each dataflow generates).  The
fields are those of the JAX package's ``TPUSpec``, so a spec built from
the TPU numbers reproduces the JAX package's choices exactly.

The traffic formulas mirror the paper's §5.2 analysis:

- **IP** streams the whole of B once per stationary row sweep → B traffic
  scales with the number of row stripes unless B fits in the streaming cache,
  but produces *zero* psum traffic (full sums only).
- **OP** reads A and B exactly once, but every k's rank-1 update revisits C
  blocks → psum read+write traffic proportional to the number of partial
  blocks.
- **Gust** gathers one B fiber per stationary nonzero → B traffic scales with
  nnz(A) × fiber size, amortized by the cache when B's rows fit; psums stay in
  the current output fiber so C traffic is write-once unless the row panel
  exceeds the psum store.

Also implements the inter-layer transition legality of Table 4 (M-stationary
emits row-major, N-stationary emits column-major; a mismatch costs an explicit
conversion) and a per-network dataflow planner.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "DeviceSpec",
    "LayerShape",
    "DataflowEstimate",
    "estimate",
    "estimate_all",
    "select_dataflow",
    "transition_needs_conversion",
    "plan_network",
]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator, as the roofline estimate sees it.

    Defaults: NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU data
    sheet (dense rates, no structured sparsity) at its 700 W limit.
    ``vmem_bytes`` is the on-chip store the estimate's cache and psum terms
    model; on Hopper that is the 50 MB L2 cache.
    """

    peak_flops: float = 989e12          # bf16 FLOP/s, tensor cores, dense
    hbm_bw: float = 3.35e12             # HBM3 bytes/s
    ici_bw: float = 450e9               # NVLink bytes/s each way
    vmem_bytes: int = 50 * 2 ** 20      # L2 cache working set
    dtype_bytes: int = 2                # bf16 operand storage
    acc_bytes: int = 4                  # fp32 psum storage


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """SpMSpM operation features — the mapper's input (paper Fig. 3b)."""

    m: int
    k: int
    n: int
    density_a: float                    # block-level occupancy of A
    density_b: float
    block: Tuple[int, int, int] = (128, 128, 128)   # (bm, bk, bn)

    @property
    def grid(self) -> Tuple[int, int, int]:
        bm, bk, bn = self.block
        return (math.ceil(self.m / bm), math.ceil(self.k / bk),
                math.ceil(self.n / bn))


@dataclasses.dataclass
class DataflowEstimate:
    dataflow: str
    flops: float
    bytes_a: float
    bytes_b: float
    bytes_c: float
    bytes_psum: float
    compute_s: float
    memory_s: float

    @property
    def total_bytes(self) -> float:
        return self.bytes_a + self.bytes_b + self.bytes_c + self.bytes_psum

    @property
    def time_s(self) -> float:
        return max(self.compute_s, self.memory_s)


def _expected_c_density(kb: int, da: float, db: float) -> float:
    """P(C block nonzero) = 1 - (1 - da*db)^Kb under independence."""
    p = da * db
    if p <= 0:
        return 0.0
    return 1.0 - (1.0 - p) ** kb


def estimate(shape: LayerShape, dataflow: str, spec: DeviceSpec = DeviceSpec()
             ) -> DataflowEstimate:
    """Roofline-style time estimate of one dataflow on ``spec``.

    M- and N-stationary variants are duals: the N estimate is the M estimate
    of the transposed problem.
    """
    base = dataflow[:-2] if dataflow.endswith(("_m", "_n")) else dataflow
    if dataflow.endswith("_n"):
        t = LayerShape(shape.n, shape.k, shape.m, shape.density_b,
                       shape.density_a,
                       (shape.block[2], shape.block[1], shape.block[0]))
        est = estimate(t, base + "_m", spec)
        return dataclasses.replace(est, dataflow=dataflow)

    mb, kb, nb = shape.grid
    bm, bk, bn = shape.block
    da, db = shape.density_a, shape.density_b
    dc = _expected_c_density(kb, da, db)

    bytes_ab = spec.dtype_bytes
    nnzb_a = da * mb * kb
    nnzb_b = db * kb * nb
    a_bytes_1 = nnzb_a * bm * bk * bytes_ab          # read-once A traffic
    b_bytes_1 = nnzb_b * bk * bn * bytes_ab          # read-once B traffic
    c_blocks = dc * mb * nb
    c_bytes_1 = c_blocks * bm * bn * bytes_ab        # write-once C traffic

    # Effectual block GEMMs = expected intersections (identical across
    # dataflows: they compute the same products, paper §2.2).
    work_blocks = mb * nb * kb * da * db
    flops = 2.0 * work_blocks * bm * bk * bn

    psum = 0.0
    if base == "ip":
        # C row panel stationary; stream B once per row stripe.  The streaming
        # cache (VMEM share) absorbs re-reads when B fits.
        row_stripes = mb
        b_footprint = nnzb_b * bk * bn * bytes_ab
        cache = spec.vmem_bytes * 0.5
        reload = 1.0 if b_footprint <= cache else float(row_stripes)
        bytes_b = b_bytes_1 * reload
        bytes_a = a_bytes_1
        bytes_c = c_bytes_1
    elif base == "op":
        # A, B read once; psum blocks written+read per (i, j, k) contribution
        # beyond the first (merging across k batches through the psum store).
        bytes_a, bytes_b, bytes_c = a_bytes_1, b_bytes_1, c_bytes_1
        # Each contribution beyond the first to a C block is one fp32
        # read + write of that block through the psum store.
        contribs = work_blocks
        psum = max(0.0, contribs - c_blocks) * bm * bn * spec.acc_bytes * 2
    elif base == "gust":
        # Leader-follower: every A element gathers B's row fiber; cache gives
        # reuse when B's working set fits (GAMMA's fiber-cache advantage).
        bytes_a = a_bytes_1
        gathered = nnzb_a * (db * nb) * bk * bn * bytes_ab
        cache = spec.vmem_bytes * 0.5
        b_footprint = nnzb_b * bk * bn * bytes_ab
        bytes_b = b_bytes_1 if b_footprint <= cache else gathered
        # C row panel lives in VMEM across the fiber (write-once) unless the
        # panel itself overflows the psum share.
        panel = dc * nb * bm * bn * spec.acc_bytes
        bytes_c = c_bytes_1
        if panel > spec.vmem_bytes * 0.25:
            spill = (panel / (spec.vmem_bytes * 0.25)) - 1.0
            psum = min(1.0, spill) * c_bytes_1 * 2
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")

    total = bytes_a + bytes_b + bytes_c + psum
    return DataflowEstimate(
        dataflow=dataflow,
        flops=flops,
        bytes_a=bytes_a,
        bytes_b=bytes_b,
        bytes_c=bytes_c,
        bytes_psum=psum,
        compute_s=flops / spec.peak_flops,
        memory_s=total / spec.hbm_bw,
    )


def estimate_all(shape: LayerShape, spec: DeviceSpec = DeviceSpec()
                 ) -> Dict[str, DataflowEstimate]:
    from .dataflows import DATAFLOWS
    return {df: estimate(shape, df, spec) for df in DATAFLOWS}


def select_dataflow(shape: LayerShape, spec: DeviceSpec = DeviceSpec(),
                    allowed: Sequence[str] | None = None) -> str:
    """Pick the fastest dataflow for this layer (phase-1 decision)."""
    ests = estimate_all(shape, spec)
    if allowed is not None:
        ests = {k: v for k, v in ests.items() if k in allowed}
    return min(ests.values(), key=lambda e: (e.time_s, e.total_bytes)).dataflow


# ---------------------------------------------------------------------------
# Inter-layer dataflow transitions (paper §3.3, Table 4)
# ---------------------------------------------------------------------------

# Output major order per dataflow, and the input major order each dataflow
# needs for the *activation* operand of the next layer.  M-stationary
# dataflows consume row-major activations where Table 4 shows a green tick.
_ALLOWED_NEXT = {
    # producer          -> consumers reachable without explicit conversion
    "ip_m": {"ip_m", "gust_m", "ip_n"},
    "op_m": {"ip_m", "gust_m", "ip_n"},
    "gust_m": {"ip_m", "gust_m", "ip_n"},
    "ip_n": {"op_m", "op_n", "gust_n"},
    "op_n": {"op_m", "op_n", "gust_n"},
    "gust_n": {"op_m", "op_n", "gust_n"},
}


def transition_needs_conversion(prev: str, nxt: str) -> bool:
    """True iff going ``prev``→``nxt`` requires an explicit format conversion
    (Table 4 "EC" cells)."""
    return nxt not in _ALLOWED_NEXT[prev]


def plan_network(layers: Sequence[LayerShape], spec: DeviceSpec = DeviceSpec(),
                 conversion_cost_s: float | None = None,
                 layer_cost=None, memory_budget=None) -> List[str]:
    """Choose a per-layer dataflow sequence minimizing total time including
    explicit-conversion penalties (dynamic program over Table 4 legality).

    This is the inter-layer mechanism of contribution (2): the planner prefers
    sequences whose produced format feeds the next layer directly.

    ``layer_cost(shape, dataflow) -> seconds`` swaps the per-layer oracle —
    the seam :class:`repro_torch.backends.SelectionPolicy` implementations
    plug into (simulated cycles, measurements, …).  Default: the analytical
    roofline estimate on ``spec``; with a ``memory_budget``
    (:class:`repro_torch.memory.MemoryBudget`) the default prices each
    cell's *tiled* execution instead, so over-budget layers are charged
    their re-stream and cross-tile merge traffic.
    """
    from .dataflows import DATAFLOWS

    if not layers:
        return []
    if layer_cost is None:
        if memory_budget is not None:
            from ..memory.traffic import tiled_estimate  # lazy: no cycle

            layer_cost = lambda l, d: tiled_estimate(
                l, d, memory_budget, spec).time_s
        else:
            layer_cost = lambda l, d: estimate(l, d, spec).time_s
    est = [{d: layer_cost(l, d) for d in DATAFLOWS} for l in layers]

    def conv_cost(i: int) -> float:
        if conversion_cost_s is not None:
            return conversion_cost_s
        # re-compress the activation matrix: ~2 passes over its bytes
        l = layers[i]
        act_bytes = l.m * l.k * spec.dtype_bytes * l.density_a
        return 2.0 * act_bytes / spec.hbm_bw

    # DP over (layer, dataflow)
    cost = {df: est[0][df] for df in DATAFLOWS}
    back: List[Dict[str, str]] = []
    for i in range(1, len(layers)):
        nxt_cost, nxt_back = {}, {}
        for df in DATAFLOWS:
            best_prev, best = None, float("inf")
            for pdf in DATAFLOWS:
                c = cost[pdf] + est[i][df]
                if transition_needs_conversion(pdf, df):
                    c += conv_cost(i)
                if c < best:
                    best, best_prev = c, pdf
            nxt_cost[df] = best
            nxt_back[df] = best_prev
        cost = nxt_cost
        back.append(nxt_back)

    last = min(cost, key=cost.get)
    seq = [last]
    for b in reversed(back):
        seq.append(b[seq[-1]])
    return list(reversed(seq))
