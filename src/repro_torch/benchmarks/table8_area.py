"""Table 8 + Fig. 17 — area/power breakdown and the naive-design comparison.

Totals must reproduce Table 8 (4.21 / 5.14 / 4.62 / 5.28 mm²; 2396 / 2750 /
2481 / 2998 mW); the naive 3-network design costs ~25% more area than the
unified MRN (Fig. 17).  The port's analogue of the unification claim — one
kernel substrate instead of three — is reported as lines of the shared
kernel source (``kernels/stream.py`` and ``csrc/stream_spmm.cu``, which
carry every dataflow) against the per-dataflow wrappers.
"""
from __future__ import annotations

import os

from ..core.simulator import (
    accelerator_area, accelerator_power, naive_design_area,
)
from .common import ACCEL_ORDER, Row


def _loc(path: str) -> int:
    with open(path) as fh:
        return sum(1 for line in fh
                   if line.strip() and not line.strip().startswith(("#",
                                                                    "//")))


def _kernel_substrate_footprint() -> str:
    """Lines of kernel code shared vs per-dataflow (unification metric)."""
    base = os.path.join(os.path.dirname(__file__), "..")
    shared = (_loc(os.path.join(base, "kernels", "stream.py"))
              + _loc(os.path.join(base, "csrc", "stream_spmm.cu")))
    per_df = sum(_loc(os.path.join(base, "kernels", f))
                 for f in ("ip_spmm.py", "op_spmm.py", "gust_spmm.py"))
    return f"shared_loc={shared} per_dataflow_loc={per_df}"


def run() -> list[Row]:
    rows = []
    for a in ACCEL_ORDER:
        rows.append(Row(
            f"table8/{a}", 0.0,
            f"area_mm2={accelerator_area(a):.2f} power_mW={accelerator_power(a):.0f}",
        ))
    naive = naive_design_area()
    flex = accelerator_area("flexagon")
    rows.append(Row(
        "fig17/naive_vs_unified", 0.0,
        f"naive_mm2={naive.total_mm2:.2f} flexagon_mm2={flex:.2f} "
        f"overhead={100*(naive.total_mm2/flex-1):.0f}%(paper=25%) "
        f"mux_mm2={naive.mux_mm2:.2f}",
    ))
    rows.append(Row("fig17/kernel_substrate", 0.0, _kernel_substrate_footprint()))
    return rows
