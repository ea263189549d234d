"""Roofline summary bench section — reads the port's launch artifacts
(``artifacts/torch/roofline``) if present."""
from __future__ import annotations

import json
import os

from .common import Row

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                   "torch", "roofline")


def run() -> list[Row]:
    rows = []
    if not os.path.isdir(ART):
        return [Row("roofline/none", 0.0,
                    "run `python -m repro_torch.launch.roofline --all` first")]
    for name in sorted(os.listdir(ART)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(ART, name)) as f:
            r = json.load(f)
        cell = f"roofline/{r['arch']}/{r['shape']}"
        if r.get("status") == "skipped":
            rows.append(Row(cell, 0.0, "skipped"))
        elif r.get("status") == "ok":
            t = r["terms_s"]
            rows.append(Row(cell, 0.0,
                            f"compute={t['compute']:.3e}s "
                            f"memory={t['memory']:.3e}s "
                            f"collective={t['collective']:.3e}s "
                            f"dominant={r['dominant']} "
                            f"useful={100*r['useful_flops_ratio']:.0f}%"))
        else:
            rows.append(Row(cell, 0.0, f"status={r.get('status')}"))
    return rows
