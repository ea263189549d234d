"""Serving CLI: batched requests through the port's continuous-batching
engine, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --requests 8 --slots 4 --max-new 16 [--device cpu]

The flags are those of ``python -m repro.launch.serve`` plus ``--device``;
``--arch`` takes every registered decoder-only arch (the encoder-decoder
has no tokens-only prefill and is not served by the engine).  Weights are
random (seed 0); ``--seed`` draws the prompts.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import obs
from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..serve.engine import Request, ServeEngine


#: the archs the engine serves: every registered decoder-only arch
SERVABLE = [a for a in ARCH_IDS if get_config(a).kind != "encdec"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=SERVABLE)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card (cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    params = model.init(seed=0)
    engine = ServeEngine(model, params, slots=args.slots,
                         max_seq=args.max_seq)

    rng = np.random.default_rng(args.seed)
    t0 = obs.now_ns()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(4, 17))).astype(np.int64)
        engine.submit(Request(rid, prompt, max_new_tokens=args.max_new))
    results = engine.run_to_completion()
    dt = (obs.now_ns() - t0) / 1e9
    total_new = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"[serve] req {rid}: {results[rid][:8]}"
              f"{'...' if len(results[rid]) > 8 else ''}")
    print(f"[serve] {len(results)} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s) on {model.device} "
          f"stats={engine.stats}")
    dec = engine.latency_stats().get("serve.latency.decode_step_s", {})
    if dec:
        print(f"[serve] decode_step p50 {dec.get('p50', 0) * 1e3:.1f} ms "
              f"p99 {dec.get('p99', 0) * 1e3:.1f} ms "
              f"over {dec.get('count', 0)} steps")
    return results


if __name__ == "__main__":
    main()
