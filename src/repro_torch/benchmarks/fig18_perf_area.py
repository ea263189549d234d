"""Fig. 18 — performance/area efficiency across the 8 DNN models.

Speedup (vs SIGMA-like) divided by normalized area.  Paper claims Flexagon
averages +18% / +67% / +265% better perf/area than GAMMA-/SpArch-/SIGMA-like,
with the NLP models as the noted exception (GAMMA wins there because ~all
their layers are Gust-friendly, making the MRN's extra area dead weight —
the expected behaviour, reproduced here).
"""
from __future__ import annotations

import numpy as np

from ..core.simulator import accelerator_area
from .common import ACCEL_ORDER, Row, all_models, model_results, timed


def run() -> list[Row]:
    rows = []
    eff_acc = {a: [] for a in ACCEL_ORDER}
    for model in all_models():
        res, us = timed(model_results, model)
        total = {a: sum(r.cycles for r in res[a]) for a in ACCEL_ORDER}
        ref_area = accelerator_area("sigma_like")
        eff = {
            a: (total["sigma_like"] / total[a])
            / (accelerator_area(a) / ref_area)
            for a in ACCEL_ORDER
        }
        for a in ACCEL_ORDER:
            eff_acc[a].append(eff[a])
        rows.append(Row(
            f"fig18/{model}", us,
            " ".join(f"{a}={eff[a]:.2f}" for a in ACCEL_ORDER),
        ))
    f = np.mean(eff_acc["flexagon"])
    rows.append(Row(
        "fig18/summary", 0.0,
        f"flex_vs_gamma=+{100*(f/np.mean(eff_acc['gamma_like'])-1):.0f}%(paper=+18%) "
        f"flex_vs_sparch=+{100*(f/np.mean(eff_acc['sparch_like'])-1):.0f}%(paper=+67%) "
        f"flex_vs_sigma=+{100*(f/np.mean(eff_acc['sigma_like'])-1):.0f}%(paper=+265%)",
    ))
    return rows
