"""Unified analysis CLI — ``python -m repro_torch.analysis <subcommand>``.

One entry point over the whole static-analysis layer (the port of
``python -m repro.analysis``):

- ``lint [paths...]``        — the port's AST lint (``repro_torch.analysis.lint``)
- ``verify [options]``       — build a demo sweep of every plan family
  (six dataflows, mixed, tiled, 2-way sharded) and run the full
  ``verify_plan`` invariant + schedule + device-table checker on each
- ``trace [options]``        — ``trace_report`` host syncs / kernel
  launches / FLOPs / identity over the same sweep (the reference's
  ``jaxpr`` subcommand)
- ``schedule [options]``     — the static schedule-checker sweep alone
- ``all [paths...]``         — every pass; the exit code aggregates one
  bit per failing stage (lint=1, verify=2, trace=4, schedule=8).

The sweeps plan on the card unless ``--device cpu`` is passed.
"""
from __future__ import annotations

import sys
from typing import List, Optional

_USAGE = """\
usage: python -m repro_torch.analysis <subcommand> [args...]

subcommands:
  lint [paths...]     the port's AST lint (default path: src/repro_torch)
  verify              verify_plan + schedule checker over a plan-family sweep
  trace               trace_report host syncs / launches / FLOPs over the sweep
  schedule            static schedule-checker sweep
  all [paths...]      run every pass; exit code ORs one bit per failing stage
"""

_BITS = {"lint": 1, "verify": 2, "trace": 4, "schedule": 8}
_LINT_DEFAULT = ["src/repro_torch"]


def _demo_plans(args):
    """One plan per family the verifier dispatches on."""
    import numpy as np

    from .. import DistPartition, MemoryBudget, flexagon_plan
    from ..core import dataflows as df
    from ..core import random_sparse_dense

    rng = np.random.default_rng(args.seed)
    m, k, n = args.shape
    bs = tuple(args.block)
    a = random_sparse_dense(rng, (m, k), density=args.density,
                            block_shape=bs[:2])
    b = random_sparse_dense(rng, (k, n), density=args.density,
                            block_shape=bs[1:])
    budget = MemoryBudget(l1_bytes=1024, l2_bytes=2048)
    kw = dict(block_shape=bs, backend=args.backend, device=args.device,
              verify=False)
    for dataflow in df.DATAFLOWS:
        yield dataflow, flexagon_plan(a, b, dataflow=dataflow, **kw)
    yield "mixed", flexagon_plan(a, b, dataflow="mixed",
                                 memory_budget=budget, **kw)
    yield "op_m/tiled", flexagon_plan(a, b, dataflow="op_m",
                                      memory_budget=budget, **kw)
    yield "op_m/sharded", flexagon_plan(a, b, dataflow="op_m",
                                        partition=DistPartition(shards=2),
                                        **kw)


def _sweep_parser(prog: str):
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"python -m repro_torch.analysis {prog}")
    parser.add_argument("--shape", type=int, nargs=3, default=(64, 48, 80),
                        metavar=("M", "K", "N"))
    parser.add_argument("--block", type=int, nargs=3, default=(16, 16, 16),
                        metavar=("BM", "BK", "BN"))
    parser.add_argument("--density", type=float, default=0.35)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", default="cuda")
    parser.add_argument("--device", default=None,
                        help="where the plans live (default: the card)")
    return parser


def _verify_main(argv: Optional[List[str]] = None) -> int:
    args = _sweep_parser("verify").parse_args(argv)
    from .verify import verify_plan

    failures = 0
    for label, plan in _demo_plans(args):
        diags = verify_plan(plan)
        errs = [d for d in diags if d.is_error]
        failures += len(errs)
        print(f"  {label:<14} {type(plan).__name__:<14} "
              f"{len(diags)} diagnostic(s)  {'FAIL' if errs else 'ok'}")
        for d in errs:
            print(f"    {d}")
    print(f"verify sweep: {failures} error(s)")
    return 1 if failures else 0


def _trace_main(argv: Optional[List[str]] = None) -> int:
    args = _sweep_parser("trace").parse_args(argv)
    from .dispatch import trace_report

    failures = 0
    for label, plan in _demo_plans(args):
        report = trace_report(plan)
        errs = [d for d in report.diagnostics if d.is_error]
        failures += len(errs)
        launches = {k: v for k, v in report.launches.items() if v}
        print(f"  {label:<14} syncs={sum(report.host_syncs.values())} "
              f"ops={report.n_ops} launches={launches} "
              f"flops={report.flops:.3e} hash={report.op_hash[:12]} "
              f"{'FAIL' if errs else 'ok'}")
        for d in errs:
            print(f"    {d}")
    print(f"trace sweep: {failures} error(s)")
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE, end="")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]

    from . import lint, schedule

    if cmd == "lint":
        return lint.main(rest or _LINT_DEFAULT)
    if cmd == "verify":
        return _verify_main(rest)
    if cmd == "trace":
        return _trace_main(rest)
    if cmd == "schedule":
        return schedule.main(rest)
    if cmd == "all":
        code = 0
        stages = {
            "lint": lambda: lint.main(rest or _LINT_DEFAULT),
            "verify": lambda: _verify_main([]),
            "trace": lambda: _trace_main([]),
            "schedule": lambda: schedule.main([]),
        }
        for name, run in stages.items():
            print(f"== {name} ==")
            if run() != 0:
                code |= _BITS[name]
        return code
    print(_USAGE, end="", file=sys.stderr)
    print(f"unknown subcommand: {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
