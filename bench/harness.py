"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver and metric readers by the names in ``BENCHMARK.json``, runs the
cell once, and builds the result line.

Each piece lives in a file of its own, found by name, so that a cell of
another driver joins as new files only:

- ``BENCHMARK.json``'s ``configs[].file``: a configuration, whose
  ``driver`` names ``bench/drivers/<driver>.py`` and whose ``limits``
  hold the limit of each number compared;
- ``bench/traffic/<traffic>.json``: a traffic mix;
- ``bench/metrics/<metric>.py``: the reader of one metric, a function
  ``read(ctx)`` that returns the number or None where it finds nothing.
  A per-layer metric is read in the cells its ``workloads`` list names.

The driver's contract.  ``Run(cfg, traffic, seed, device)`` does the
set-up (everything before the window) and offers:

- ``window(seconds)``: the measured window; returns a dict whose keys go
  onto the readers' context: ``steps``, the units attempted (the result's
  ``attempted``), and what the cell's readers read (every cell's
  end-to-end readers read ``samples``, ``window_s`` and ``step_ms``);
- ``trace()``: with ``--trace 1``, after the window: None off the card or
  where the trace is no reading, else a dict as ``tracing.reduce`` gives
  it, of which the harness reads ``busy_s``, ``window_s``, ``device_ops``
  and ``idle_gaps``;
- ``free_program()``: drops the program's state, before the check;
- ``check()``: (worst, where, per unit) of the numbers compared against
  the plain reference, each named as in the configuration's ``limits``:
  ``worst`` maps each name to its worst reading, ``where`` says where
  that lies, and ``per unit`` maps each unit checked (a step, a request)
  to its readings.  Where ``limits`` holds one number, a reading may be
  that number alone.  A unit with a reading not under its limit failed.

The harness reads these where the driver has them, and None where not:
``plan_s``, ``flops_per_step`` and ``bound_s_per_step(peaks)``.  A reader
given None returns None, as it does off the card.

A reader's context (``ctx``) holds the window's keys, ``setup_s``,
``peaks`` (``work.peaks_for``), ``trace`` (what ``trace()`` gave),
``plan_s``, ``flops_per_step``, ``bound_s_per_step`` (at the peaks) and
the run itself (``ctx.run``).  A reader may leave a breakdown on
``ctx.breakdown`` (``device_ops`` and ``idle_gaps``, each a list of
[name, seconds]); the result line carries it in place of the trace's.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from bench import work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names of the JAX package and what it stands on
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


def load_spec(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_of(spec, name):
    return _named(spec["workloads"], name, "workload")


def config_of(spec, cell, root=ROOT):
    entry = _named(spec["configs"], cell["config"], "config")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic_of(name, root=ROOT):
    return json.loads((Path(root) / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def _piece(root, kind, name):
    """The module ``bench/<kind>/<name>.py`` of the checkout at ``root``."""
    path = Path(root) / "bench" / kind / f"{name}.py"
    key = f"bench_{kind}_{name}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    # a dataclass looks its module up by name while it is made
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def driver_of(cfg, root=ROOT):
    return _piece(root, "drivers", cfg["driver"])


def reader_of(name, root=ROOT):
    return _piece(root, "metrics", name).read


def metrics_of(spec, cell_name, trace):
    """The cell's end-to-end metrics (``trace`` 0) or per-layer ones (1)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def jax_modules():
    """Loaded modules whose top-level name is one of ``JAX_NAMES``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in JAX_NAMES)


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return out[0] if out else "power limit not read"


def _fails(value, limit):
    return value is None or not value <= limit


def _checked(got, limits):
    """A driver's ``check()`` as (worst by name, where, readings by unit,
    each a dict by name)."""
    worst, where, per_unit = got
    if not isinstance(worst, dict):
        [name] = limits
        worst = {name: worst}
        per_unit = {u: {name: v} for u, v in per_unit.items()}
    return worst, where, per_unit


def run(spec, cell_name, seed, seconds, trace, device, t0, cfg=None,
        traffic=None, root=ROOT):
    """Run one cell once; returns (result line, check lines).

    ``t0`` is the host clock's reading when the process started, so that
    ``setup_s`` runs from there to the window's first step.  ``cfg`` and
    ``traffic`` replace the cell's own files where given (tests); ``root``
    is the checkout whose pieces run.
    """
    import torch

    cell = cell_of(spec, cell_name)
    cfg = cfg or config_of(spec, cell, root)
    traffic = traffic or traffic_of(cell["traffic"], root)
    # the configurations state fp32: no TF32 in the program's products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    run_ = driver_of(cfg, root).Run(cfg, traffic, seed, dev)
    # what set-up made lives on: the collector's full passes skip it in
    # the window and the traced span
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    window = run_.window(seconds)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else str(dev)
    traced = run_.trace() if trace else None
    gc.unfreeze()
    bound = getattr(run_, "bound_s_per_step", None)
    ctx = SimpleNamespace(setup_s=setup_s, run=run_,
                          plan_s=getattr(run_, "plan_s", None),
                          flops_per_step=getattr(run_, "flops_per_step",
                                                 None),
                          peaks=work.peaks_for(kind), trace=traced,
                          **window)
    ctx.bound_s_per_step = (bound(ctx.peaks) if bound and ctx.peaks
                            else None)
    metrics = {}
    for m in metrics_of(spec, cell_name, trace):
        value = reader_of(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = getattr(ctx, "breakdown", None)
    run_.free_program()
    limits = cfg["limits"]
    worst, where, per_unit = _checked(run_.check(), limits)
    failed = sum(1 for got in per_unit.values()
                 if any(_fails(got.get(n), lim) for n, lim in limits.items()))
    result = {
        "correct": bool(per_unit) and failed == 0,
        "attempted": window["steps"],
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": peak},
    }
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"],
                                window_s=traced["window_s"])
        breakdown = breakdown or {"device_ops": traced["device_ops"],
                                  "idle_gaps": traced["idle_gaps"]}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": worst.get(n), "limit": lim}
                        for n, lim in limits.items()}
    pk = ctx.peaks or {}
    lines = [f"card {card_line() if on_card else kind}; peaks: fp32 "
             f"{pk.get('fp32_flop_per_s')} FLOP/s, bf16 "
             f"{pk.get('bf16_flop_per_s')} FLOP/s, HBM "
             f"{pk.get('hbm_bytes_per_s')} B/s ({pk.get('source')})",
             f"checked steps {sorted(per_unit)}, worst at {where}",
             *([f"traced idle by step (s): {traced.get('idle_by_step')}"]
               if traced else []),
             *(["the trace lost operations: no trace metrics"]
               if trace and on_card and traced is None else []),
             *(f"{n} {worst.get(n)!r} limit {lim!r}"
               for n, lim in limits.items())]
    return result, lines
