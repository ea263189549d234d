"""Kernel microbenchmarks: plan-build vs steady-state apply, per backend.

The port of ``benchmarks/kernels_bench.py``.  On the card (``--device
cuda``, the default) the ``cuda`` backend's applies launch K1/K2
(``repro_torch.kernels.stream``); on the CPU (``--device cpu``) every
backend runs the plain versions, and the times are the host's.  Each
timed loop is bracketed by ``torch.cuda.synchronize()`` on the card, so a
row's time covers the device work it queued.  What the bench establishes:

- ``plan_build`` — one-time phase-1 cost (occupancy, policy, layouts,
  index plans, backend prepare);
- ``plan_apply`` — steady-state phase-2 cost, the number that matters for a
  serving loop;
- ``per_call``   — the one-shot path (plan + apply on every invocation),
  which pays both.

``plan_apply`` must not exceed ``per_call`` on any (shape, backend)
(asserted).  Everything routes through the backend registry.

Each (dataflow, backend) row also records the memory behaviour of the
operation under the paper's Table 5 on-chip budget
(``repro_torch.memory``): on-chip bytes, off-chip bytes, the tiles the
dataflow's scheduler needs, and the interconnect bytes of its partition
over ``DIST_SHARDS`` shards; the case's mixed-mode tile histogram gets its
own ``mixed_tiles`` row.  A ``cuda`` row's ``extra`` holds the K1/K2
launches of its applies.

CLI::

    python -m repro_torch.benchmarks.kernels_bench --quick \
        --json chiprun_out/BENCH_kernels_h100.json [--device cpu]

``--verify`` gates every (untimed) plan build behind
``repro_torch.analysis.verify_plan``; ``--trace out.json`` writes a
Chrome-trace JSON of every ``repro_torch.obs`` span.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter

import numpy as np
import torch

from .. import PAPER_BUDGET, flexagon_plan, get_policy, obs
from ..analysis import check_schedule, verify_plan
from ..backends import SelectionContext, allowed_dataflows, get_backend
from ..core import random_sparse_dense
from ..core.formats import block_occupancy
from ..core.dataflows import DATAFLOWS
from ..core.selector import DeviceSpec, LayerShape
from ..kernels import stream
from ..memory import mixed_tile_choices, sharded_traffic, tiled_traffic
from .common import Row

BACKENDS = ("reference", "cuda")
BS = (16, 16, 16)
#: shard count for the analytic multi-device pricing (pattern-level, so no
#: actual devices are needed — the row tracks the trajectory, not wall-clock)
DIST_SHARDS = 4
CASES = [
    ("sq_like", 64, 64, 128, 0.3, 0.9),
    ("op_like", 64, 256, 64, 0.1, 0.5),
    ("gust_like", 128, 128, 64, 0.5, 0.2),
]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, reps=3):
    fn()  # warmup (and the kernels' first build on the card)
    _sync(device)
    t0 = obs.now_ns()
    for _ in range(reps):
        fn()
    _sync(device)
    return (obs.now_ns() - t0) / reps / 1e3


def _launches() -> int:
    return stream.stream_spmm.launches + stream.stream_panel_spmm.launches


def _max_err(out, ref) -> float:
    return float(np.abs(out.double().cpu().numpy() - ref).max())


def run(quick: bool = False, verify: bool = False,
        device=None) -> list[Row]:
    """The rows; ``device=None`` is the card."""
    from ..config import resolve_device

    device = resolve_device(device)
    rows = []
    rng = np.random.default_rng(7)
    cases = CASES[:1] if quick else CASES
    dataflows = ("ip_m", "op_m", "gust_m") if quick else DATAFLOWS
    # an apply on the card takes about 0.1 ms, and one timed call is
    # mostly the host's noise: time 20 times as many there
    reps = (1 if quick else 3) * (20 if device.type == "cuda" else 1)
    for name, m, k, n, da, db in cases:
        a_np = random_sparse_dense(rng, (m, k), density=da,
                                   block_shape=BS[:2])
        b_np = random_sparse_dense(rng, (k, n), density=db,
                                   block_shape=BS[1:])
        ref = a_np.astype(np.float64) @ b_np.astype(np.float64)
        a = torch.as_tensor(a_np, device=device)
        b = torch.as_tensor(b_np, device=device)
        occ_a = block_occupancy(a_np, BS[:2])
        occ_b = block_occupancy(b_np, BS[1:])
        # memory behaviour per dataflow under the Table 5 on-chip budget
        # (backend-independent: the schedule depends on pattern + budget)
        memory = {
            df: tiled_traffic(df, occ_a, occ_b, BS, PAPER_BUDGET)
            for df in dataflows
        }
        # multi-device trajectory: the dataflow's partition strategy over a
        # virtual DIST_SHARDS-shard mesh, interconnect tier included
        dist = {
            df: sharded_traffic(df, occ_a, occ_b, BS, DIST_SHARDS,
                                budget=PAPER_BUDGET)
            for df in dataflows
        }
        # the mixed-mode trajectory (DESIGN.md §14): per-tile dataflow
        # histogram of the case's mixed schedule under the same budget —
        # reported on its own row (it describes the *mixed* schedule, not
        # any single-dataflow plan's tiles)
        mixed_hist = dict(Counter(
            mixed_tile_choices(occ_a, occ_b, BS, PAPER_BUDGET)))
        rows.append(Row(
            f"kernels/{name}/mixed_tiles", 0.0,
            " ".join(f"{d}={c}" for d, c in sorted(mixed_hist.items())),
            extra={"tile_dataflows": mixed_hist}))
        for backend in BACKENDS:
            # per-dataflow correctness + latency through the registry
            for df in dataflows:
                plan = flexagon_plan(a, b, dataflow=df, block_shape=BS,
                                     backend=backend, device=device,
                                     verify=verify or None)
                before = _launches()
                us = _time(lambda p=plan: p.apply(a, b), device, reps=reps)
                err = _max_err(plan.apply(a, b), ref)
                launches = _launches() - before
                t = memory[df]
                d = dist[df]
                rows.append(Row(
                    f"kernels/{name}/{backend}/{df}", us,
                    f"max_err={err:.1e} onchip={t.onchip_bytes:.0f}B "
                    f"tiles={t.tiles} ici={d.ici_bytes:.0f}B",
                    extra={"onchip_bytes": t.onchip_bytes,
                           "l1_bytes": t.l1_bytes,
                           "l2_bytes": t.l2_bytes,
                           "dram_bytes": t.dram_bytes,
                           "tiles": t.tiles,
                           "mesh_shape": [DIST_SHARDS],
                           "shards": DIST_SHARDS,
                           "ici_bytes": d.ici_bytes,
                           "kernel_launches": launches,
                           # this row's own plan: a fixed-dataflow plan's
                           # tiles all run its dataflow (untiled -> one)
                           "tile_dataflows":
                               getattr(plan, "tile_histogram", None)
                               or {df: 1}}))

            # phase split: plan once (build) vs execute many (apply) vs the
            # seed-equivalent per-call path that pays both every time
            build_us = _time(
                lambda be=backend: flexagon_plan(a, b, block_shape=BS,
                                                 backend=be, device=device),
                device, reps=reps)
            plan = flexagon_plan(a, b, block_shape=BS, backend=backend,
                                 device=device, verify=verify or None)
            before = _launches()
            apply_us = _time(lambda: plan.apply(a, b), device,
                             reps=max(reps, 2))
            apply_launches = _launches() - before
            per_call_us = _time(
                lambda be=backend: flexagon_plan(
                    a, b, block_shape=BS, backend=be,
                    device=device).apply(a, b),
                device, reps=max(reps, 2))
            err = _max_err(plan.apply(a, b), ref)
            rows.append(Row(f"kernels/{name}/{backend}/plan_build", build_us,
                            f"dataflow={plan.dataflow}"))
            # static-analysis overhead (DESIGN.md §19): full verify_plan —
            # plan invariants + the schedule checker — on the built plan,
            # plus the schedule checker alone, both as fractions of
            # plan_build so the "checker costs <10% of planning" budget is
            # tracked as a bench trajectory, not an anecdote
            verify_us = _time(lambda: len(verify_plan(plan)), device,
                              reps=max(reps, 2))
            if getattr(plan, "aux", None) \
                    and "stream_schedule" in plan.aux:
                sched_us = _time(lambda: len(check_schedule(plan)), device,
                                 reps=max(reps, 2))
            else:
                sched_us = 0.0      # no aux schedule on this backend
            rows.append(Row(
                f"kernels/{name}/{backend}/plan_verify", verify_us,
                f"of_build={verify_us / build_us:.3f} "
                f"sched_of_build={sched_us / build_us:.3f}",
                extra={"verify_us": verify_us, "build_us": build_us,
                       "schedule_checker_us": sched_us,
                       "verify_over_build": verify_us / build_us,
                       "schedule_checker_over_build":
                           sched_us / build_us}))
            rows.append(Row(f"kernels/{name}/{backend}/plan_apply", apply_us,
                            f"max_err={err:.1e}",
                            extra={"kernel_launches": apply_launches,
                                   "device": str(device)}))
            rows.append(Row(f"kernels/{name}/{backend}/per_call", per_call_us,
                            "per-call plan+apply"))
            # 1.25x headroom so scheduler noise on a loaded box doesn't abort
            # the whole run; the reported rows carry the actual numbers
            assert apply_us <= per_call_us * 1.25, (
                f"{name}/{backend}: steady-state apply ({apply_us:.0f}us) "
                f"slower than per-call plan+apply ({per_call_us:.0f}us)")

        # selection policies, through the same seam the plans use; each row
        # carries which policy selected and how long its select() takes
        # ("learned" runs model-less here — heuristic fallback — unless
        # REPRO_TUNE_MODEL names a fitted artifact; DESIGN.md §16)
        shape = LayerShape(m, k, n, float(occ_a.mean()), float(occ_b.mean()),
                           block=BS)
        ctx = SelectionContext(
            shape=shape, block_shape=BS, occ_a=occ_a, occ_b=occ_b,
            fingerprint=f"bench:{name}", backend=get_backend("reference"),
            spec=DeviceSpec(), allowed=allowed_dataflows(
                get_backend("reference"), BS), device=device)
        sel_reps = 5 if quick else 15
        for pname in ("heuristic", "simulator", "learned"):
            pol = get_policy(pname)
            choice = pol.select(ctx)        # warmup (fills policy caches)
            # selection latency as a distribution, not a single draw: the
            # row reports p50/p99 over repeats (scheduler noise on shared
            # CI boxes makes one-shot numbers useless for trajectories)
            lats = []
            for _ in range(sel_reps):
                t0 = obs.now_ns()
                assert pol.select(ctx) == choice
                lats.append((obs.now_ns() - t0) / 1e9)
            sel = {"count": len(lats),
                   "mean": float(np.mean(lats)),
                   "min": float(np.min(lats)),
                   "max": float(np.max(lats)),
                   "p50": float(np.percentile(lats, 50)),
                   "p99": float(np.percentile(lats, 99))}
            plan = flexagon_plan(a, b, block_shape=BS, policy=pol,
                                 device=device)
            assert plan.dataflow == choice, (name, pname)
            rows.append(Row(f"kernels/{name}/policy_{pname}",
                            sel["p50"] * 1e6,
                            f"choice={plan.dataflow}",
                            extra={"policy": pname,
                                   "selection_latency_s": sel}))
    return rows


def _device_header(device) -> dict:
    """Where the rows were taken: the card's name and power limit as
    ``nvidia-smi`` reports them, or the CPU."""
    if torch.device(device).type != "cuda":
        return {"type": "cpu"}
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"type": "cuda", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[:1]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="1 case, 3 dataflows, 1 rep (20 on the card) (CI smoke)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write rows as JSON (CI artifact)")
    ap.add_argument("--verify", action="store_true",
                    help="gate every built plan behind "
                         "repro_torch.analysis.verify_plan (raises on error)")
    ap.add_argument("--trace", metavar="PATH",
                    help="capture a repro_torch.obs span trace of the whole "
                         "run and write Chrome-trace/Perfetto JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where the operands and plans live (default cuda)")
    args = ap.parse_args(argv)
    if args.trace:
        obs.enable()
    rows = run(quick=args.quick, verify=args.verify, device=args.device)
    print("name,us_per_call,derived")
    for row in rows:
        print(row.csv())
    if args.json:
        payload = {
            "bench": "kernels",
            "quick": args.quick,
            "device": _device_header(args.device),
            "rows": [r.json() for r in rows],
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# wrote {args.json}")
    if args.trace:
        n = obs.get_tracer().save_chrome(args.trace)
        print(f"# wrote {n} spans -> {args.trace} "
              "(open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
