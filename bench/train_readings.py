"""The readings that a training cell's limits are set from, on the card,
at the cell's own size: the program's ``loss_rel_err``, ``grad_rel_err``,
``route_gap`` and ``update_rel_err`` over some seeds, and the control's
(the reference with every product's inputs rounded through float8 e4m3,
in the program's place) on the same parameters, moments and batches.

    python3 bench/train_readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--unpinned-seeds 1] [--min-steps N] \\
        [--sample-below N] [--seconds S]

One process for all seeds; one JSON line per seed on standard output:
each kept step's readings, the worst leaf and the worst leaf that is no
router's.  Each seed runs the cell's set-up, a window of ``--min-steps``
steps and the check, as a run does.  ``--unpinned-seeds`` also compares
the program with the reference routing on its own logits, as the check
did before it pinned the routes.  The benchmark's own runs never run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _leaves(run):
    """Per kept step: the worst leaf, and the worst that is no router's."""
    out = {}
    for i, errs in run.leaf_errors.items():
        top = sorted(errs.items(), key=lambda kv: -kv[1])
        other = [kv for kv in top if "router" not in kv[0]]
        out[i] = {"worst": top[0], "worst_not_router": other[0]}
    return out


def readings(cell_name, seeds, control_seeds=(), min_steps=None,
             seconds=0.0, device="cuda", unpinned_seeds=(),
             sample_below=None):
    """Yield one dict per seed (module docstring)."""
    import torch

    from bench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, cell_name)
    cfg = harness.config_of(spec, cell)
    traffic = harness.traffic_of(cell["traffic"])
    if min_steps:
        traffic = dict(traffic, min_steps=min_steps)
    if sample_below:
        traffic = dict(traffic, check={"sample_below": sample_below})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = harness.driver_of(cfg)
    for seed in seeds:
        t = time.perf_counter()
        run = driver.Run(cfg, traffic, seed, torch.device(device))
        window = run.window(seconds)
        run.free_program()
        _, where, per = run.check()
        row = {"workload": cell_name, "seed": seed, "steps": window["steps"],
               "program": per, "program_at": where,
               "program_leaves": _leaves(run), "limits": cfg["limits"]}
        if seed in unpinned_seeds:
            _, row["unpinned_at"], row["unpinned"] = run.check(pinned=False)
            row["unpinned_leaves"] = _leaves(run)
        if seed in control_seeds:
            _, row["control_at"], row["control"] = run.control()
            row["control_leaves"] = _leaves(run)
        row["seconds"] = time.perf_counter() - t
        del run
        if device == "cuda":
            torch.cuda.empty_cache()
        yield row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--unpinned-seeds", default="")
    p.add_argument("--min-steps", type=int, default=None)
    p.add_argument("--sample-below", type=int, default=None)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    unpinned = {int(s) for s in args.unpinned_seeds.split(",") if s}
    for row in readings(args.workload, seeds, controls, args.min_steps,
                        args.seconds, unpinned_seeds=unpinned,
                        sample_below=args.sample_below):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
