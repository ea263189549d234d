"""Fig. 13 — layer-wise performance on the nine Table 6 layers.

Speedups vs SIGMA-like.  Paper claims per group: IP-friendly layers favor
SIGMA (1.53× / 1.40× vs SpArch/GAMMA), OP-friendly favor SpArch (5.07× /
2.66×), Gust-friendly favor GAMMA (4.37× / 3.19×); Flexagon always matches
the best (overall 2.81× / 1.69× / 1.55×).
"""
from __future__ import annotations

import numpy as np

from ..core.simulator import ACCELERATORS, from_layer, simulate
from ..core.workloads import PAPER_LAYERS, PAPER_LAYER_GROUPS
from .common import ACCEL_ORDER, Row, timed


def run() -> list[Row]:
    rows = []
    ratios = {a: [] for a in ACCEL_ORDER}
    winners_ok = 0
    group_of = {l: g for g, ls in PAPER_LAYER_GROUPS.items() for l in ls}
    best_map = {"ip": "sigma_like", "op": "sparch_like", "gust": "gamma_like"}
    for name, spec in PAPER_LAYERS.items():
        (st,), us = timed(lambda s: (from_layer(s),), spec)
        cyc = {a: simulate(a, st).cycles for a in ACCELERATORS}
        sp = {a: cyc["sigma_like"] / cyc[a] for a in ACCEL_ORDER}
        for a in ACCEL_ORDER:
            ratios[a].append(cyc[a] / cyc["flexagon"])
        best = min(ACCEL_ORDER[:3], key=lambda a: cyc[a])
        winners_ok += best == best_map[group_of[name]]
        rows.append(Row(
            f"fig13/{name}", us,
            " ".join(f"{a}={sp[a]:.2f}x" for a in ACCEL_ORDER)
            + f" best={best}",
        ))
    rows.append(Row(
        "fig13/summary", 0.0,
        f"flex_vs_sigma={np.mean(ratios['sigma_like']):.2f}x(paper=2.81x) "
        f"flex_vs_sparch={np.mean(ratios['sparch_like']):.2f}x(paper=1.69x) "
        f"flex_vs_gamma={np.mean(ratios['gamma_like']):.2f}x(paper=1.55x) "
        f"group_winners={winners_ok}/9(paper=9/9)",
    ))
    return rows
