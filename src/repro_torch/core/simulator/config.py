"""Accelerator configuration — paper Table 5, plus derived constants."""
from __future__ import annotations

import dataclasses

__all__ = ["AcceleratorConfig", "PAPER_CONFIG"]


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """64-multiplier configuration used for all four accelerators (Table 5)."""

    num_multipliers: int = 64
    num_adders: int = 63
    dn_bandwidth: int = 16            # elements / cycle (distribution)
    rn_bandwidth: int = 16            # elements / cycle (reduce / merge)
    word_bytes: int = 4               # 32-bit (value + coordinate) element
    l1_latency: int = 1               # cycles
    sta_fifo_bytes: int = 256
    str_cache_bytes: int = 1 << 20    # 1 MiB
    str_line_bytes: int = 128
    str_assoc: int = 16
    str_banks: int = 16
    psram_bytes: int = 256 << 10      # 256 KiB
    dram_latency_ns: float = 100.0
    dram_bw_bytes_per_s: float = 256e9
    freq_hz: float = 800e6            # TSMC 28 nm @ 800 MHz (paper §4)
    #: chip-to-chip interconnect bandwidth (the dist layer's fourth traffic
    #: tier; 50 GB/s per link matches the launch-side roofline constants)
    ici_bw_bytes_per_s: float = 50e9
    #: effective outstanding demand misses for irregular (Gust) gathers —
    #: bounded by the shared DRAM controller queue, not the 16 cache banks.
    #: Calibrated on the Table 6 OP-vs-Gust crossover (see EXPERIMENTS.md).
    gather_mlp: int = 8

    @property
    def elems_per_line(self) -> int:
        return self.str_line_bytes // self.word_bytes

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bw_bytes_per_s / self.freq_hz

    @property
    def ici_bytes_per_cycle(self) -> float:
        return self.ici_bw_bytes_per_s / self.freq_hz

    @property
    def dram_latency_cycles(self) -> float:
        return self.dram_latency_ns * 1e-9 * self.freq_hz


PAPER_CONFIG = AcceleratorConfig()
