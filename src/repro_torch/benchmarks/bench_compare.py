"""Compare two ``kernels_bench --json`` snapshots and fail on regressions.

The port of ``benchmarks/bench_compare.py``.  The baseline is the H100
``--quick`` snapshot committed beside this module,
``BENCH_kernels_h100.json`` (its ``device`` header names the card and its
power limit); a fresh snapshot from the same card is compared with it, and
any ``plan_apply`` row — the steady-state number a serving loop pays —
that regresses more than the threshold (default 25%) fails.  Compare
snapshots of one card only.

The threshold is tighter than the spread of these host-clock rows: four
``--quick`` runs in one call on an H100 (NVIDIA H100 80GB HBM3, 700.00 W),
nothing else on the host, 20 timed calls a row, spread 1.4-2.1x from
fastest to slowest per row (``cuda`` ``plan_apply`` 78.3-158.7 µs).  A
single fresh run against the baseline can fail on noise alone: compare
runs taken in one call, and read a failure as a reason to rerun.

Usage::

    python -m repro_torch.benchmarks.bench_compare new.json \
        [--baseline PATH] [--suffix plan_apply] [--threshold 1.25]

Exit status 1 on any regression; rows present in only one snapshot are
reported but never fail the run (quick mode covers a subset of cases).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

#: the committed H100 snapshot
BASELINE = os.path.join(os.path.dirname(__file__), "BENCH_kernels_h100.json")


def load_rows(path: str, suffix: str) -> dict:
    with open(path) as f:
        payload = json.load(f)
    return {r["name"]: float(r["us_per_call"])
            for r in payload.get("rows", [])
            if r["name"].endswith(f"/{suffix}")}


def compare(baseline: dict, current: dict, threshold: float) -> list[str]:
    """Return one message per regressed row (empty = pass)."""
    failures = []
    for name in sorted(baseline):
        if name not in current:
            print(f"  skip {name}: missing from current snapshot")
            continue
        old, new = baseline[name], current[name]
        ratio = new / old if old > 0 else float("inf")
        status = "FAIL" if ratio > threshold else "ok"
        print(f"  {status:4s} {name}: {old:.0f}us -> {new:.0f}us "
              f"({ratio:.2f}x)")
        if ratio > threshold:
            failures.append(
                f"{name} regressed {ratio:.2f}x (> {threshold:.2f}x): "
                f"{old:.0f}us -> {new:.0f}us")
    for name in sorted(set(current) - set(baseline)):
        print(f"  new  {name}: {current[name]:.0f}us (no baseline)")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("current", help="freshly produced snapshot")
    ap.add_argument("--baseline", default=BASELINE,
                    help="committed snapshot (default: the H100 one)")
    ap.add_argument("--suffix", default="plan_apply",
                    help="row-name suffix to compare (default: plan_apply)")
    ap.add_argument("--threshold", type=float, default=1.25,
                    help="max allowed new/old ratio (default: 1.25)")
    args = ap.parse_args(argv)

    baseline = load_rows(args.baseline, args.suffix)
    current = load_rows(args.current, args.suffix)
    if not baseline:
        sys.exit(f"no */{args.suffix} rows in {args.baseline}")
    print(f"comparing {len(baseline)} {args.suffix} rows "
          f"(threshold {args.threshold:.2f}x):")
    failures = compare(baseline, current, args.threshold)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        sys.exit(1)
    print("no regressions")


if __name__ == "__main__":
    main()
