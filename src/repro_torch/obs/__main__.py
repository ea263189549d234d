"""``python -m repro_torch.obs`` — trace-file tooling.

The port of ``python -m repro.obs``.  Subcommands over the native JSONL
trace format written by :meth:`repro_torch.obs.Tracer.save`:

- ``demo``       capture a trace from a mixed-dataflow plan build + serve
                 decode steps and write ``trace.jsonl`` (+ ``--chrome``);
                 it runs on the card unless ``--device cpu`` is passed
- ``export``     convert a native trace to Chrome-trace/Perfetto JSON
                 (open at https://ui.perfetto.dev)
- ``summarize``  per-span latency table (count / total / mean / p50 / p99)
- ``dump``       print spans one per line (tree-indented by parent)
- ``validate``   schema-check a Chrome-trace JSON file (CI gate): every
                 event carries ``ph``/``ts``/``pid``/``tid``/``name``,
                 durations are non-negative, parent references resolve
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.obs import trace as _trace
from repro_torch.obs.trace import (SpanRecord, get_tracer, read_spans,
                             spans_to_chrome, summarize)


def _cmd_demo(args) -> int:
    # deferred: the demo is the only subcommand that needs torch and the
    # plan API
    import numpy as np
    import torch

    _trace.enable()
    from repro_torch import MemoryBudget, flexagon_plan
    from repro_torch.config import resolve_device
    from repro_torch.core import random_sparse_dense
    from repro_torch.obs import get_registry

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    # heterogeneous pattern: dense band + uniform-sparse remainder — the
    # mixed planner picks per-tile dataflows
    ah = np.zeros((96, 96), np.float32)
    ah[:48] = rng.standard_normal((48, 96)).astype(np.float32)
    ah[48:] = random_sparse_dense(rng, (48, 96), density=0.5,
                                  block_shape=(8, 8))
    bh = random_sparse_dense(rng, (96, 96), density=0.9, block_shape=(8, 8))
    a, b = (torch.as_tensor(x, device=device) for x in (ah, bh))
    budget = MemoryBudget(l1_bytes=20000, l2_bytes=40000)
    plan = flexagon_plan(a, b, dataflow="mixed", block_shape=(8, 8, 8),
                         memory_budget=budget, policy="simulator",
                         backend="cuda", device=device)
    # each apply re-enters Python, so the trace shows one
    # memory.tiled.apply span per execution
    for _ in range(args.steps):
        plan.apply(a, b)

    if args.serve:
        # a real request lifecycle: admit -> prefill -> decode -> complete
        # spans from the continuous-batching engine (smoke-sized model)
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.serve import Request, ServeEngine

        cfg = get_config("smollm-360m", smoke=True)
        model = build_model(cfg, device=device)
        params = model.init(seed=0)
        eng = ServeEngine(model, params, slots=2, max_seq=64,
                          dtype=torch.float32)
        for rid in range(2):
            prompt = rng.integers(0, cfg.vocab, size=6).astype(np.int64)
            eng.submit(Request(rid, prompt, max_new_tokens=args.steps))
        eng.run_to_completion()
        dec = eng.latency_stats().get("serve.latency.decode_step_s", {})
        print(f"[obs] serve decode_step p50 {dec.get('p50', 0) * 1e3:.2f} ms "
              f"over {dec.get('count', 0)} steps")

    tracer = get_tracer()
    n = tracer.save(args.out)
    print(f"[obs] {n} spans -> {args.out}")
    if args.chrome:
        tracer.save_chrome(args.chrome)
        print(f"[obs] Chrome-trace JSON -> {args.chrome} "
              "(open at https://ui.perfetto.dev)")
    print(tracer.summarize())
    print("[obs] metrics snapshot:")
    print(get_registry().to_json())
    return 0


def _cmd_export(args) -> int:
    spans = read_spans(args.trace)
    doc = spans_to_chrome(spans)
    out = args.out or (args.trace.rsplit(".", 1)[0] + ".chrome.json")
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
    print(f"[obs] {len(spans)} spans -> {out} "
          "(open at https://ui.perfetto.dev)")
    return 0


def _cmd_summarize(args) -> int:
    print(summarize(read_spans(args.trace)))
    return 0


def _cmd_dump(args) -> int:
    spans = read_spans(args.trace)
    depth: Dict[int, int] = {}
    by_sid = {s.sid: s for s in spans}

    def level(s: SpanRecord) -> int:
        d = depth.get(s.sid)
        if d is None:
            parent = by_sid.get(s.parent) if s.parent is not None else None
            d = 0 if parent is None else level(parent) + 1
            depth[s.sid] = d
        return d

    for s in sorted(spans, key=lambda r: r.t0_ns):
        attrs = " ".join(f"{k}={v}" for k, v in sorted(s.attrs.items()))
        print(f"{'  ' * level(s)}{s.name}  {s.dur_ns / 1e3:.1f}us"
              f"{('  ' + attrs) if attrs else ''}")
    return 0


def validate_chrome(doc: Any) -> List[str]:
    """Chrome-trace schema errors for an exported JSON document ([] = ok)."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a 'traceEvents' array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    sids = set()
    for i, ev in enumerate(events):
        for field in ("ph", "ts", "pid", "tid", "name"):
            if field not in ev:
                errors.append(f"event {i}: missing {field!r}")
        if ev.get("ph") == "X":
            if "dur" not in ev:
                errors.append(f"event {i}: complete event without 'dur'")
            elif ev["dur"] < 0:
                errors.append(f"event {i}: negative duration {ev['dur']}")
        sid = ev.get("args", {}).get("sid")
        if sid is not None:
            sids.add(sid)
    # balance: every parent reference resolves to a captured span (the ring
    # buffer can age parents out — only flag parents newer than the oldest
    # captured sid, which cannot have been dropped)
    floor = min(sids) if sids else 0
    for i, ev in enumerate(events):
        parent = ev.get("args", {}).get("parent")
        if parent is not None and parent >= floor and parent not in sids:
            errors.append(f"event {i}: unbalanced span — parent {parent} "
                          "missing from trace")
    return errors


def _cmd_validate(args) -> int:
    with open(args.trace, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    errors = validate_chrome(doc)
    n = len(doc.get("traceEvents", [])) if isinstance(doc, dict) else 0
    if errors:
        for e in errors:
            print(f"[obs] INVALID: {e}", file=sys.stderr)
        return 1
    print(f"[obs] {args.trace}: {n} events, schema OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="trace a mixed plan build + applies")
    d.add_argument("--out", default="trace.jsonl")
    d.add_argument("--chrome", default=None,
                   help="also write Chrome-trace JSON here")
    d.add_argument("--steps", type=int, default=10)
    d.add_argument("--serve", action="store_true",
                   help="also run a smoke ServeEngine (request span trees)")
    d.add_argument("--device", default=None,
                   help="where the demo runs (default: the card)")
    d.set_defaults(fn=_cmd_demo)

    e = sub.add_parser("export", help="native trace -> Chrome-trace JSON")
    e.add_argument("trace")
    e.add_argument("--out", default=None)
    e.set_defaults(fn=_cmd_export)

    s = sub.add_parser("summarize", help="per-span latency table")
    s.add_argument("trace")
    s.set_defaults(fn=_cmd_summarize)

    du = sub.add_parser("dump", help="print spans (tree-indented)")
    du.add_argument("trace")
    du.set_defaults(fn=_cmd_dump)

    v = sub.add_parser("validate", help="schema-check Chrome-trace JSON")
    v.add_argument("trace")
    v.set_defaults(fn=_cmd_validate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
