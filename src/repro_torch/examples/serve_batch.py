"""Serving example: batched requests through the continuous-batching engine.

Mixed-length prompts share fused decode steps; slots free up and refill from
the queue as sequences finish (per-slot position vectors keep the KV cache
consistent).  The port of ``examples/serve_batch.py``, on
``repro_torch.launch.serve``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batch
      [--arch qwen2-1.5b] [--device cpu]
"""
import argparse

from ..launch import serve as serve_driver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args(argv)
    return serve_driver.main(["--arch", args.arch, "--smoke", "--requests",
                              str(args.requests), "--slots", "4",
                              "--max-new", "12", "--device", args.device])


if __name__ == "__main__":
    main()
