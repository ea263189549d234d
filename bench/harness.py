"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver and metric readers by the names in ``BENCHMARK.json``, runs the
cell once, and builds the result line.

Each piece lives in a file of its own, found by name:

- ``BENCHMARK.json``'s ``configs[].file``: a configuration, whose
  ``driver`` names ``bench/drivers/<driver>.py`` and whose ``limits``
  hold the limit of each number compared;
- ``bench/traffic/<traffic>.json``: a traffic mix;
- ``bench/metrics/<metric>.py``: the reader of one metric, a function
  ``read(ctx)`` that returns the number or None where it finds nothing.
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


def traffic_of(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def driver_of(cfg):
    return importlib.import_module(f"bench.drivers.{cfg['driver']}")


def reader_of(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


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


def run(spec, cell_name, seed, seconds, trace, device, t0, cfg=None,
        traffic=None):
    """Run one cell once; returns (result line, check lines).

    ``t0`` is the host clock's reading when the process started, so that
    ``setup_s`` runs from there to the window's first step.  ``cfg`` and
    ``traffic`` replace the cell's own files where given (tests).
    """
    import torch

    cell = cell_of(spec, cell_name)
    cfg = cfg or config_of(spec, cell)
    traffic = traffic or traffic_of(cell["traffic"])
    # the configurations state fp32: no TF32 in the program's products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    run_ = driver_of(cfg).Run(cfg, traffic, seed, dev)
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
    ctx = SimpleNamespace(setup_s=setup_s, plan_s=run_.plan_s,
                          flops_per_step=run_.flops_per_step,
                          peaks=work.peaks_for(kind), trace=traced,
                          **window)
    ctx.bound_s_per_step = (run_.bound_s_per_step(ctx.peaks)
                            if ctx.peaks else None)
    metrics = {}
    for m in metrics_of(spec, cell_name, trace):
        value = reader_of(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run_.free_program()
    worst, where, per_step = run_.check()
    limit = cfg["limits"]["max_rel_err"]
    failed = sum(1 for v in per_step.values() if not v <= limit)
    result = {
        "correct": bool(per_step) and failed == 0,
        "attempted": window["steps"],
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": peak},
    }
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"],
                                window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {"max_rel_err": {"value": worst, "limit": limit}}
    pk = ctx.peaks or {}
    lines = [f"card {card_line() if on_card else kind}; peaks: fp32 "
             f"{pk.get('fp32_flop_per_s')} FLOP/s, HBM "
             f"{pk.get('hbm_bytes_per_s')} B/s ({pk.get('source')})",
             f"checked steps {sorted(per_step)}, worst at {where}",
             *([f"traced idle by step (s): {traced['idle_by_step']}"]
               if traced else []),
             *(["the trace lost operations: no trace metrics"]
               if trace and on_card and traced is None else []),
             f"max_rel_err {worst!r} limit {limit!r}"]
    return result, lines
