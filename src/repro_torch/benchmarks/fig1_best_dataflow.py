"""Fig. 1 — the dataflow that wins each layer, per DNN model.

Paper claims: NLP models (DB, MB) trend strongly to Gustavson (84% / 100% of
layers in §5.3); extremely sparse models (S-R, V) favor OP in ~73–75% of
layers; CV models are mixed.  ``derived`` reports the per-dataflow share of
layers won.
"""
from __future__ import annotations

from collections import Counter

from .common import Row, all_models, model_results, timed

_FIXED = ["sigma_like", "sparch_like", "gamma_like"]
_NAME = {"sigma_like": "IP", "sparch_like": "OP", "gamma_like": "Gust"}


def run() -> list[Row]:
    rows = []
    for model in all_models():
        res, us = timed(model_results, model)
        wins = Counter()
        for i in range(len(res["flexagon"])):
            best = min(_FIXED, key=lambda a: res[a][i].cycles)
            wins[_NAME[best]] += 1
        n = sum(wins.values())
        shares = " ".join(
            f"{d}={wins.get(d, 0) / n:.2f}" for d in ("IP", "OP", "Gust")
        )
        rows.append(Row(f"fig1/{model}", us, shares))
    return rows
