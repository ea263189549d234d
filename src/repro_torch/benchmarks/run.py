"""Benchmark runner — one section per paper table/figure.

The port of ``benchmarks/run.py``: ``python -m repro_torch.benchmarks.run
[section] [--device cuda|cpu] [--quick]``.  Prints the
``name,us_per_call,derived`` CSV contract.  Sections:
  fig1    — best dataflow per layer, per model
  fig12   — end-to-end speedups (CPU MKL + 4 accelerators)
  fig13   — layer-wise speedups on the nine Table 6 layers
  fig14-16— on-chip traffic, miss rates, off-chip traffic
  table8  — area/power breakdown + Fig 17 naive-vs-unified
  fig18   — performance/area efficiency
  kernels — the plan API per backend on ``--device`` (the ``cuda``
            backend launches K1/K2 on the card); ``--quick`` is one case
  roofline— roofline summary (if ``repro_torch.launch.roofline`` artifacts
            exist)
"""
from __future__ import annotations

import argparse
import functools
import sys
import traceback


def _sections():
    from . import (fig1_best_dataflow, fig12_end_to_end, fig13_layerwise,
                   fig14_traffic, fig18_perf_area, kernels_bench,
                   roofline_report, table4_transitions, table8_area)
    return [
        ("fig1", fig1_best_dataflow),
        ("fig12", fig12_end_to_end),
        ("fig13", fig13_layerwise),
        ("fig14-16", fig14_traffic),
        ("table4", table4_transitions),
        ("table8", table8_area),
        ("fig18", fig18_perf_area),
        ("kernels", kernels_bench),
        ("roofline", roofline_report),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("section", nargs="?", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the kernels section runs (default cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="the kernels section's one-case smoke")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    failed = 0
    for name, mod in _sections():
        if args.section and args.section != name:
            continue
        run = mod.run
        if name == "kernels":
            run = functools.partial(run, quick=args.quick, device=args.device)
        try:
            for row in run():
                print(row.csv())
        except Exception:
            failed += 1
            print(f"{name}/ERROR,0,exception")
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
