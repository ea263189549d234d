"""Fig. 14/15/16 — memory behaviour on the nine Table 6 layers.

Per layer and accelerator: on-chip traffic split by L1 structure (STA FIFO /
STR cache / PSRAM, in MB — Fig. 14), STR cache miss rate (Fig. 15), and
off-chip traffic (KB — Fig. 16).  Paper anchors: STA traffic negligible
everywhere; SIGMA-like V0 miss rate 3.13% vs SpArch 0.36% / GAMMA 2.30%;
IP has zero PSRAM traffic.
"""
from __future__ import annotations

from ..core.simulator import from_layer, simulate
from ..core.workloads import PAPER_LAYERS
from .common import ACCEL_ORDER, Row, timed


def run() -> list[Row]:
    rows = []
    for name, spec in PAPER_LAYERS.items():
        (st,), us = timed(lambda s: (from_layer(s),), spec)
        for a in ACCEL_ORDER:
            r = simulate(a, st)
            rows.append(Row(
                f"fig14-16/{name}/{a}", us if a == ACCEL_ORDER[0] else 0.0,
                f"sta_MB={r.sta_read_bytes/1e6:.3f} "
                f"str_MB={r.str_read_bytes/1e6:.2f} "
                f"psram_MB={r.psram_rw_bytes/1e6:.2f} "
                f"miss_rate={100*r.miss_rate:.2f}% "
                f"offchip_KB={r.offchip_bytes/1e3:.0f}",
            ))
    return rows
