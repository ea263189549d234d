"""Phase-analytical cycle models of the four accelerators (paper §4–§5).

All four share the Table 5 substrate (64 multipliers, 16-elem/cycle DN and
RN/MRN, 1 MiB STR cache, 256 KiB PSRAM, 256 GB/s HBM); they differ only in
dataflow and which memory structures carry traffic — exactly the paper's
"-like" normalization.  Per layer each model reports:

- cycles per execution phase (stationary fill / streaming / merging) with the
  layer's DRAM-bound correction,
- on-chip traffic through each L1 structure (STA FIFO, STR cache, PSRAM),
- STR cache accesses/misses (analytical set-associative model: compulsory
  lines + thrash term when the streamed working set exceeds capacity),
- off-chip traffic (compressed A, B-miss refills, C writeback, PSRAM spills).

Fidelity: phase-granularity closed forms over exact per-fiber nonzero counts
(see stats.py), not per-cycle event simulation — validated in EXPERIMENTS.md
against the paper's claims (per-layer dataflow winners, speedup ordering,
miss-rate magnitudes, e.g. the 1/32-per-sweep compulsory rate on V0).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from .config import AcceleratorConfig, PAPER_CONFIG
from .stats import LayerStats

__all__ = [
    "SimResult", "simulate_ip", "simulate_op", "simulate_gust",
    "simulate_flexagon", "simulate", "ACCELERATORS",
]


@dataclasses.dataclass
class SimResult:
    accelerator: str
    dataflow: str
    layer: str
    fill_cycles: float
    stream_cycles: float
    merge_cycles: float
    dram_cycles: float
    sta_read_bytes: float
    str_read_bytes: float
    psram_rw_bytes: float
    str_accesses: float
    str_misses: float
    offchip_bytes: float
    stall_cycles: float = 0.0   # demand-miss stalls (irregular gathers only)

    @property
    def compute_cycles(self) -> float:
        return (self.fill_cycles + self.stream_cycles + self.merge_cycles
                + self.stall_cycles)

    @property
    def cycles(self) -> float:
        """Total cycles: compute pipeline or DRAM stream, whichever binds."""
        return max(self.compute_cycles, self.dram_cycles)

    @property
    def miss_rate(self) -> float:
        return min(1.0, self.str_misses / max(1.0, self.str_accesses))

    @property
    def onchip_bytes(self) -> float:
        return self.sta_read_bytes + self.str_read_bytes + self.psram_rw_bytes


def _lines(nbytes: float, cfg: AcceleratorConfig) -> float:
    return math.ceil(max(0.0, nbytes) / cfg.str_line_bytes)


def _data_lines(nnz: float, cfg: AcceleratorConfig) -> float:
    """Cache lines of the (coord,value) element stream only — the pointer
    vectors ride the dedicated tile-reader registers (paper §3.4), so they
    never count as STR cache accesses/misses."""
    return math.ceil(max(0.0, nnz) * cfg.word_bytes / cfg.str_line_bytes)


def _pack_rounds(fiber_sizes: np.ndarray, capacity: int) -> int:
    """Greedy in-order packing of stationary fibers into multiplier slots.

    Fibers larger than ``capacity`` are split (SIGMA's FAN / the MRN support
    flexible cluster sizes).  Returns the number of stationary iterations.
    """
    rounds, used = 0, 0
    for s in fiber_sizes:
        s = int(s)
        if s == 0:
            continue
        while s > 0:
            if used == capacity:
                rounds += 1
                used = 0
            take = min(s, capacity - used)
            used += take
            s -= take
    return rounds + (1 if used > 0 else 0)


def _merge_passes(n_fibers: float, leaves: int) -> int:
    """Tree passes to merge ``n_fibers`` sorted fibers through ``leaves``."""
    if n_fibers <= 1:
        return 0
    return max(1, math.ceil(math.log(max(2.0, n_fibers), leaves)))


def _dram_cycles(offchip_bytes: float, cfg: AcceleratorConfig) -> float:
    return offchip_bytes / cfg.dram_bytes_per_cycle + cfg.dram_latency_cycles


def simulate_ip(st: LayerStats, cfg: AcceleratorConfig = PAPER_CONFIG
                ) -> SimResult:
    """SIGMA-like, Inner Product (M): stationary A rows, stream all of B per
    round, FAN reduction, zero psum traffic."""
    w = cfg.word_bytes
    rounds = max(1, _pack_rounds(st.a_row_nnz, cfg.num_multipliers))
    cs_b = st.cs_bytes("b", w)

    fill = st.nnz_a / cfg.dn_bandwidth
    stream = max(
        rounds * st.nnz_b / cfg.dn_bandwidth,   # multicast B sweep per round
        st.mults / cfg.num_multipliers,          # effectual dot products
        st.nnz_c / cfg.rn_bandwidth,             # full sums drained at the root
    )

    accesses = float(rounds) * st.nnz_b
    if cs_b <= cfg.str_cache_bytes:
        misses = float(_data_lines(st.nnz_b, cfg))   # compulsory only
    else:
        misses = float(rounds) * _data_lines(st.nnz_b, cfg)  # cyclic thrash

    offchip = st.cs_bytes("a", w) + misses * cfg.str_line_bytes \
        + st.cs_bytes("c", w)
    return SimResult(
        accelerator="sigma_like", dataflow="ip_m", layer=st.spec.name,
        fill_cycles=fill, stream_cycles=stream, merge_cycles=0.0,
        dram_cycles=_dram_cycles(offchip, cfg),
        sta_read_bytes=st.nnz_a * w,
        str_read_bytes=accesses * w,
        psram_rw_bytes=0.0,
        str_accesses=accesses, str_misses=misses, offchip_bytes=offchip,
    )


def simulate_op(st: LayerStats, cfg: AcceleratorConfig = PAPER_CONFIG
                ) -> SimResult:
    """SpArch-like, Outer Product (M): stationary A column elements, stream B
    rows, psums through PSRAM, multi-pass merge per output row."""
    w = cfg.word_bytes
    cs_b = st.cs_bytes("b", w)

    fill = st.nnz_a / cfg.dn_bandwidth
    stream = max(
        st.nnz_b / cfg.dn_bandwidth,             # B injected once (multicast)
        st.mults / cfg.num_multipliers,
        st.mults / cfg.rn_bandwidth,             # every psum written to PSRAM
    )

    # Merge phase: each output row m holds a_row_nnz[m] psum fibers totalling
    # row_psums[m] elements; >64 fibers need extra passes through the merger.
    visits = 0.0
    for fibers, psums in zip(st.a_row_nnz, st.row_psums):
        visits += float(psums) * _merge_passes(float(fibers), cfg.num_multipliers)
    merge = visits / cfg.rn_bandwidth

    accesses = float(st.mults)                    # one use per effectual mult
    misses = float(_data_lines(st.nnz_b, cfg))    # B streamed once: compulsory

    psum_bytes = float(st.mults) * w
    spill = max(0.0, psum_bytes - cfg.psram_bytes)
    offchip = st.cs_bytes("a", w) + misses * cfg.str_line_bytes \
        + st.cs_bytes("c", w) + 2.0 * spill
    return SimResult(
        accelerator="sparch_like", dataflow="op_m", layer=st.spec.name,
        fill_cycles=fill, stream_cycles=stream, merge_cycles=merge,
        dram_cycles=_dram_cycles(offchip, cfg),
        sta_read_bytes=st.nnz_a * w,
        str_read_bytes=accesses * w,
        psram_rw_bytes=2.0 * psum_bytes,          # write + consume
        str_accesses=accesses, str_misses=misses, offchip_bytes=offchip,
    )


def simulate_gust(st: LayerStats, cfg: AcceleratorConfig = PAPER_CONFIG
                  ) -> SimResult:
    """GAMMA-like, Gustavson (M): stationary A rows, leader-follower B row
    fetches through the STR cache, merge overlapped unless fibers > leaves."""
    w = cfg.word_bytes
    cs_b = st.cs_bytes("b", w)

    fill = st.nnz_a / cfg.dn_bandwidth
    stream = max(
        st.mults / cfg.dn_bandwidth,              # each fetched element private
        st.mults / cfg.num_multipliers,
    )

    # Merge overlapped with multiply while a row's fiber count fits the tree;
    # extra passes (and PSRAM round trips) otherwise.
    extra_visits = 0.0
    psram_bytes = 0.0
    for fibers, psums in zip(st.a_row_nnz, st.row_psums):
        passes = _merge_passes(float(fibers), cfg.num_multipliers)
        if passes > 1:
            extra_visits += float(psums) * (passes - 1)
            psram_bytes += float(psums) * w * 2.0
    merge = extra_visits / cfg.rn_bandwidth

    accesses = float(st.mults)
    compulsory = float(_data_lines(st.nnz_b, cfg))
    if cs_b <= cfg.str_cache_bytes:
        misses = compulsory                        # whole B resident: fiber reuse
    else:
        # each leader element refetches its B row; partial reuse scales with
        # how much of B the cache can keep
        refetch = float(
            np.sum(st.a_col_nnz * np.ceil(st.b_row_nnz * w / cfg.str_line_bytes))
        )
        beta = min(1.0, max(0.0, (cs_b - cfg.str_cache_bytes) / cs_b))
        misses = compulsory + beta * max(0.0, refetch - compulsory)

    # Gust's fetch pattern is "irregular and unpredictable" (paper §3.4):
    # demand misses expose DRAM latency, amortized by the memory-level
    # parallelism of the banked cache + DRAM controller queue rather than
    # hidden by streaming prefetch (IP/OP access B sequentially).
    stalls = misses * cfg.dram_latency_cycles / cfg.gather_mlp

    spill = max(0.0, psram_bytes / 2.0 - cfg.psram_bytes)
    offchip = st.cs_bytes("a", w) + misses * cfg.str_line_bytes \
        + st.cs_bytes("c", w) + 2.0 * spill
    return SimResult(
        accelerator="gamma_like", dataflow="gust_m", layer=st.spec.name,
        fill_cycles=fill, stream_cycles=stream, merge_cycles=merge,
        dram_cycles=_dram_cycles(offchip, cfg),
        sta_read_bytes=st.nnz_a * w,
        str_read_bytes=accesses * w,
        psram_rw_bytes=psram_bytes,
        str_accesses=accesses, str_misses=misses, offchip_bytes=offchip,
        stall_cycles=stalls,
    )


def simulate_flexagon(st: LayerStats, cfg: AcceleratorConfig = PAPER_CONFIG
                      ) -> SimResult:
    """Flexagon: the mapper/compiler (phase 1) picks the best dataflow per
    layer; the MRN + 3-tier memory then run it (paper: "always reaching the
    performance of the best case")."""
    candidates = [simulate_ip(st, cfg), simulate_op(st, cfg),
                  simulate_gust(st, cfg)]
    best = min(candidates, key=lambda r: r.cycles)
    return dataclasses.replace(best, accelerator="flexagon")


def simulate(accelerator: str, st: LayerStats,
             cfg: AcceleratorConfig = PAPER_CONFIG) -> SimResult:
    return ACCELERATORS[accelerator](st, cfg)


ACCELERATORS = {
    "sigma_like": simulate_ip,
    "sparch_like": simulate_op,
    "gamma_like": simulate_gust,
    "flexagon": simulate_flexagon,
}
