"""Fill the dry-run and roofline tables of ``PERF.md`` §8 from the port's
artifacts (``artifacts/torch/dryrun``, ``artifacts/torch/roofline``).

The port of ``repro.launch.report``.  Each table is one row per arch and
one column per shape, and replaces the text between its markers,
``<!-- DRYRUN_TABLE -->`` ... ``<!-- /DRYRUN_TABLE -->`` and
``<!-- ROOFLINE_TABLE -->`` ... ``<!-- /ROOFLINE_TABLE -->``.

    PYTHONPATH=src python -m repro_torch.launch.report [--perf PERF.md]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

from ..configs import ARCH_IDS
from ..configs.base import SHAPES

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
DRYRUN = os.path.join(ROOT, "artifacts", "torch", "dryrun")
ROOFLINE = os.path.join(ROOT, "artifacts", "torch", "roofline")
PERF = os.path.join(ROOT, "PERF.md")


def _load(d):
    out = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
    return out


def _baseline(rows):
    return [r for r in rows if r.get("variant", "baseline") == "baseline"]


def _status(r) -> str:
    return {"ok": "ok", "skipped": "skip", "error": "ERR"}.get(
        (r or {}).get("status"), "—")


def dryrun_table(d: str = DRYRUN) -> str:
    cells = {}
    for r in _baseline(_load(d)):
        cells[(r["arch"], r["shape"], bool(r.get("multi_pod")))] = r

    def cell(arch, shape):
        sp = cells.get((arch, shape, False))
        mp = cells.get((arch, shape, True))
        if sp is None or sp.get("status") != "ok":
            text = _status(sp)
        else:
            text = (f"{sp['memory']['peak_bytes_per_device'] / 2 ** 30:.1f} / "
                    f"{sp['cost']['flops'] / 1e12:.3g} / "
                    f"{sp['collective_bytes_total'] / 2 ** 30:.1f}")
        return text + (f" (mp {_status(mp)})" if mp is not None else "")

    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    lines += [f"| {a} | " + " | ".join(cell(a, s) for s in SHAPES) + " |"
              for a in ARCH_IDS]
    sp = [r for k, r in cells.items() if not k[2]]
    mp = [r for k, r in cells.items() if k[2]]
    count = lambda rows, s: sum(r.get("status") == s for r in rows)
    lines.append("")
    lines.append(
        f"Single pod (16 x 16): {count(sp, 'ok')} ok, "
        f"{count(sp, 'error')} error, {count(sp, 'skipped')} skipped; "
        f"multi-pod (2 x 16 x 16): {count(mp, 'ok')} ok of {len(mp)} run.  "
        "Each cell: peak GiB per device / TFLOP per device / collective "
        "GiB per device, rank 0's counts on meta tensors (not measured on "
        "a device).")
    return "\n".join(lines)


def roofline_table(d: str = ROOFLINE) -> str:
    rows = {(r["arch"], r["shape"]): r for r in _baseline(_load(d))}

    def cell(arch, shape):
        r = rows.get((arch, shape))
        if r is None or r.get("status") != "ok":
            return _status(r)
        t = r["terms_s"]
        mark = "" if r.get("ratio_reliable", True) else "†"
        return (f"{r['dominant'][:4]} {max(t.values()):.3g} s, "
                f"{100 * r['useful_flops_ratio']:.0f}%{mark}")

    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    lines += [f"| {a} | " + " | ".join(cell(a, s) for s in SHAPES) + " |"
              for a in ARCH_IDS]
    lines.append("")
    lines.append(
        "Each cell: the dominant term (comp(ute), memo(ry), coll(ective)) "
        "and its seconds per step per chip, from the counted FLOPs, bytes "
        "and collective bytes over DeviceSpec's 989 TFLOP/s, 3.35 TB/s and "
        "450 GB/s (the H100 SXM data sheet at 700 W: not measured); then "
        "useful = MODEL_FLOPS / (counted FLOPs x 256 chips), † where that "
        "ratio exceeded 1.5 and was capped.")
    return "\n".join(lines)


def fill(text: str, marker: str, table: str) -> str:
    pattern = re.compile(rf"(<!-- {marker} -->\n).*?(<!-- /{marker} -->)",
                         re.S)
    if not pattern.search(text):
        raise ValueError(f"no <!-- {marker} --> ... <!-- /{marker} --> "
                         "markers")
    return pattern.sub(lambda m: m.group(1) + table + "\n" + m.group(2),
                       text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--perf", default=PERF)
    ap.add_argument("--dryrun-dir", default=DRYRUN)
    ap.add_argument("--roofline-dir", default=ROOFLINE)
    args = ap.parse_args(argv)
    with open(args.perf) as f:
        text = f.read()
    text = fill(text, "DRYRUN_TABLE", dryrun_table(args.dryrun_dir))
    text = fill(text, "ROOFLINE_TABLE", roofline_table(args.roofline_dir))
    with open(args.perf, "w") as f:
        f.write(text)
    print(f"{args.perf} updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
