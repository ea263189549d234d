"""Fig. 12 — end-to-end model performance: CPU MKL vs the four accelerators.

Speedups are time-based: CPU cycles (Table 2, i5-7400 @ 3 GHz) against
simulated accelerator cycles @ 800 MHz.  Paper claims: Flexagon beats the
fixed-dataflow accelerators on every model; averages 4.59× vs SIGMA-like,
1.71× vs SpArch-like, 1.35× vs GAMMA-like, and ~31× vs CPU MKL.
"""
from __future__ import annotations

import numpy as np

from ..core.workloads import CPU_CYCLES_1E6
from .common import ACCEL_ORDER, Row, all_models, model_results, timed

CPU_FREQ = 3.0e9
ACCEL_FREQ = 800e6


def run() -> list[Row]:
    rows = []
    ratios = {a: [] for a in ACCEL_ORDER}
    cpu_speedups = []
    for model in all_models():
        res, us = timed(model_results, model)
        total = {a: sum(r.cycles for r in res[a]) for a in ACCEL_ORDER}
        t_cpu = CPU_CYCLES_1E6[model] * 1e6 / CPU_FREQ
        sp = {a: t_cpu / (total[a] / ACCEL_FREQ) for a in ACCEL_ORDER}
        for a in ACCEL_ORDER[:3]:
            ratios[a].append(total[a] / total["flexagon"])
        cpu_speedups.append(sp["flexagon"])
        derived = " ".join(f"{a}={sp[a]:.1f}x" for a in ACCEL_ORDER)
        rows.append(Row(f"fig12/{model}", us, derived))

    gmean = lambda xs: float(np.exp(np.mean(np.log(xs))))
    rows.append(Row(
        "fig12/summary", 0.0,
        f"flex_vs_sigma={np.mean(ratios['sigma_like']):.2f}x(paper=4.59x) "
        f"flex_vs_sparch={np.mean(ratios['sparch_like']):.2f}x(paper=1.71x) "
        f"flex_vs_gamma={np.mean(ratios['gamma_like']):.2f}x(paper=1.35x) "
        f"flex_vs_cpu={np.mean(cpu_speedups):.0f}x(paper=31x,gmean={gmean(cpu_speedups):.0f}x)",
    ))
    return rows
