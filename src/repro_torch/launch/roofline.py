"""Roofline analysis of every (arch x shape) cell on the single-pod mesh.

The port of ``repro.launch.roofline``.  Three terms per chip, from the
counts of :class:`repro_torch.launch.dryrun.CostMode`:

    compute    = FLOPs_per_chip / peak FLOP/s          (989 TFLOP/s bf16)
    memory     = bytes_per_chip / HBM rate             (3.35 TB/s)
    collective = collective_bytes_per_chip / link rate (450 GB/s NVLink)

The rates are :class:`repro_torch.core.selector.DeviceSpec`'s, the H100
SXM data sheet at 700 W; they are the device's limits, not measurements.

Method.  The reference lowers reduced-depth probes with every scan unrolled
and extrapolates over the layer count, because XLA counts a loop body once.
The port's dry-run (``launch/dryrun.py``) already counts the whole step at
full depth, eagerly, as rank 0 of a fake process group, so the roofline
reads its FLOPs, bytes, collectives and memory from the dry-run artifact
and counts a cell itself (``dryrun.run_cell``) only when no artifact
holds it.  ``probe`` records the depth and microbatches counted.  A train
cell is counted at the cell's microbatches, the step as it runs, where the
reference probes one microbatch: the FLOPs are the same up to the
accumulation's adds, and the unfused bytes grow with the microbatches
(each reads the weights again).  MODEL_FLOPS = 6·N·D (train) / 2·N·D
(inference) with N = active params (MoE counts top_k/E of expert params);
the ratio MODEL_FLOPS / counted FLOPs measures how much of the counted
compute is useful.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline --arch X --shape Y
    PYTHONPATH=src python -m repro_torch.launch.roofline --all
    PYTHONPATH=src python -m repro_torch.launch.roofline --summary
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from .. import obs
from ..configs import ARCH_IDS, get_config
from ..configs.base import SHAPES
from ..core.selector import DeviceSpec
from .dryrun import run_cell
from .specs import VARIANTS, cell_is_supported, meta_model_init

__all__ = ["active_params", "model_flops", "analyze_cell", "summary"]

SPEC = DeviceSpec()
CHIPS = 256

HINTS = {
    "compute": "raise tensor-core utilization (wgmma-sized tiles, fusion, "
               "less recompute)",
    "memory": "cut HBM traffic (better remat policy, fuse elementwise "
              "chains, bf16 psums where safe)",
    "collective": "re-shard to shrink per-layer all-gathers (larger TP "
                  "blocks / fewer FSDP gathers) and overlap collectives "
                  "with compute over NVLink",
}


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def active_params(cfg) -> float:
    """Active parameter count (MoE experts weighted by top_k / E).

    The reference weights every leaf whose path names ``w_gate``, ``w_up``
    or ``w_down`` and whose rank is at least 3 in JAX's stacked layout.
    The port keeps one dict per layer in a list, so a leaf under a list
    counts one rank more (the layer axis JAX stacks it on): the same
    leaves are weighted."""
    params = meta_model_init(cfg, lambda m: m.init(0))
    total = 0.0

    def visit(tree, path, stacked):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, path + (str(k),), stacked)
            return
        if isinstance(tree, list):
            for i, v in enumerate(tree):
                visit(v, path + (str(i),), True)
            return
        n = float(tree.numel())
        p = "/".join(path)
        if cfg.moe is not None and any(
                w in p for w in ("w_gate", "w_up", "w_down")) \
                and tree.dim() + int(stacked) >= 3:
            n *= cfg.moe.top_k / cfg.moe.num_experts
        total += n

    visit(params, (), False)
    return total


def model_flops(cfg, shape) -> float:
    n = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if cfg.kind == "encdec":
        # encoder sees seq/4 frame tokens, decoder sees the text tokens
        # (1 for prefill's priming token); N splits ~evenly enc/dec
        enc_tokens = shape.global_batch * max(1, shape.seq_len // 4)
        if shape.kind == "train":
            return 6.0 * (n / 2) * enc_tokens + 6.0 * (n / 2) * tokens
        if shape.kind == "prefill":
            return 2.0 * (n / 2) * enc_tokens + 2.0 * (n / 2) \
                * shape.global_batch
        return 2.0 * (n / 2) * tokens          # decode: decoder only
    if shape.kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------


def dryrun_record(arch: str, shape_name: str, variant: str = "baseline",
                  dryrun_dir: str = "artifacts/torch/dryrun") -> dict:
    """The dry-run's record of the cell on the single-pod mesh: its
    artifact under ``dryrun_dir``, else counted now (not written).  Raises
    if the artifact records an error."""
    suffix = "" if variant == "baseline" else f"__{variant}"
    path = os.path.join(dryrun_dir, f"{arch}__{shape_name}__sp{suffix}.json")
    if not os.path.exists(path):
        return run_cell(arch, shape_name, multi_pod=False, variant=variant,
                        verbose=False)
    with open(path) as f:
        rec = json.load(f)
    if rec["status"] != "ok":
        raise RuntimeError(f"the dry-run of this cell is {rec['status']}: "
                           f"{rec.get('error')}")
    return rec


def analyze_cell(arch: str, shape_name: str, *,
                 dryrun_dir: str = "artifacts/torch/dryrun",
                 variant: str = "baseline") -> dict:
    reason = cell_is_supported(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason}
    cfg_fn, _ = VARIANTS[variant]
    cfg = cfg_fn(get_config(arch))
    shape = SHAPES[shape_name]
    t0 = obs.now_ns()
    rec = dryrun_record(arch, shape_name, variant, dryrun_dir)
    flops = rec["cost"]["flops"]
    hbytes = rec["cost"]["bytes_accessed"]
    cbytes = float(rec["collective_bytes_total"])

    compute_s = flops / SPEC.peak_flops
    memory_s = hbytes / SPEC.hbm_bw
    collective_s = cbytes / SPEC.ici_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]

    mf = model_flops(cfg, shape)
    useful_ratio = mf / max(1.0, flops * CHIPS)
    reliable = True
    if useful_ratio > 1.5:
        reliable = False
        useful_ratio = min(useful_ratio, 1.0)

    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "variant": variant,
        "seconds": round((obs.now_ns() - t0) / 1e9, 1),
        "per_chip": {"flops": flops, "hbm_bytes": hbytes,
                     "collective_bytes": cbytes},
        "terms_s": {"compute": compute_s, "memory": memory_s,
                    "collective": collective_s},
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": useful_ratio,
        "ratio_reliable": reliable,
        "memory": rec["memory"],
        "microbatches": rec["microbatches"],
        "hint": HINTS[dominant],
        "probe": {"layers": cfg.n_layers,
                  "encoder_layers": cfg.n_encoder_layers,
                  "microbatches": rec["microbatches"],
                  "collectives": rec["collectives"],
                  "flops_by_op": rec["flops_by_op"]},
    }


def summary(roofline_dir: str = "artifacts/torch/roofline") -> str:
    rows = []
    for name in sorted(os.listdir(roofline_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(roofline_dir, name)) as f:
            rows.append(json.load(f))
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant "
        "| MODEL_FLOPS | useful | mem/dev GiB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped: {r['reason'][:40]}… | — | — | — |")
            continue
        if r.get("status") != "ok":
            continue
        t = r["terms_s"]
        mem = r.get("memory") or {}
        peak = mem.get("peak_bytes_per_device", 0) / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute']:.3e} | "
            f"{t['memory']:.3e} | {t['collective']:.3e} | {r['dominant']} | "
            f"{r['model_flops']:.2e} | {100 * r['useful_flops_ratio']:.0f}% | "
            f"{peak:.1f} |")
    return "\n".join(lines)


def _roof_one(arch, shape, variant, dryrun_dir, out):
    suffix = "" if variant == "baseline" else f"__{variant}"
    try:
        res = analyze_cell(arch, shape, variant=variant,
                           dryrun_dir=dryrun_dir)
        if res["status"] == "ok":
            t = res["terms_s"]
            print(f"[roofline] {arch} × {shape}: "
                  f"compute={t['compute']:.3e}s memory={t['memory']:.3e}s "
                  f"coll={t['collective']:.3e}s -> {res['dominant']} "
                  f"useful={100*res['useful_flops_ratio']:.0f}% "
                  f"({res['seconds']}s)", flush=True)
        else:
            print(f"[roofline] {arch} × {shape}: {res['status']}")
    except Exception as e:   # noqa: BLE001
        traceback.print_exc()
        res = {"arch": arch, "shape": shape, "variant": variant,
               "status": "error", "error": repr(e)[:2000]}
    with open(os.path.join(out, f"{arch}__{shape}{suffix}.json"), "w") as f:
        json.dump(res, f, indent=2)
    return res["status"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--dryrun-dir", default="artifacts/torch/dryrun")
    ap.add_argument("--out", default="artifacts/torch/roofline")
    args = ap.parse_args(argv)

    if args.summary:
        print(summary(args.out))
        return 0
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s, args.variant, args.dryrun_dir, args.out)
             for a in archs for s in shapes]
    status = [_roof_one(*c) for c in cells]
    return 1 if "error" in status else 0


if __name__ == "__main__":
    sys.exit(main())
