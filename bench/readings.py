"""The readings that the limit of each compared number is set from, on the
card, at a cell's own size: the program's reading over many seeds and the
control's (the reference in TF32 in the program's place) over some.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 1] [--samples N]

One process for all seeds; one JSON line per seed on standard output.
Each seed runs the cell's set-up, a short window and the check, as a run
does; where the seed is also a control seed, the control is read on the
same operands.  ``--samples`` changes the samples a step (the tests use a
small size).  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell_name, seeds, control_seeds=(), seconds=1.0, samples=None,
             device="cuda"):
    """Yield one dict per seed: the program's and, for a control seed,
    the control's worst ``max_rel_err``."""
    import torch

    from bench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, cell_name)
    cfg = harness.config_of(spec, cell)
    traffic = harness.traffic_of(cell["traffic"])
    if samples:
        traffic = dict(traffic, samples_per_step=samples)
    torch.backends.cuda.matmul.allow_tf32 = False
    driver = harness.driver_of(cfg)
    for seed in seeds:
        t = time.perf_counter()
        run = driver.Run(cfg, traffic, seed, torch.device(device))
        window = run.window(seconds)
        run.free_program()
        worst, where, _ = run.check()
        row = {"workload": cell_name, "seed": seed, "samples": traffic[
            "samples_per_step"], "steps": window["steps"],
            "program": worst, "program_at": where,
            "limit": cfg["limits"]["max_rel_err"]}
        if seed in control_seeds:
            row["control"], row["control_at"], _ = run.control()
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
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--samples", type=int, default=None)
    args = p.parse_args(argv)
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for row in readings(args.workload, seeds, controls, args.seconds,
                        args.samples):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
