"""End-to-end training driver example.

Trains a reduced-config model with the production path: microbatched
gradient accumulation, async checkpointing, and a restart that resumes from
the last checkpoint (the fault-tolerance loop).  The port of
``examples/train_lm.py``, on ``repro_torch.launch.train``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm
      [--arch smollm-360m] [--steps 200] [--device cpu]
"""
import argparse
import math
import shutil
import tempfile

from ..configs import get_config
from ..configs.base import TrainConfig
from ..launch import train as train_driver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=5e-3,
                       warmup_steps=max(1, args.steps // 10),
                       total_steps=args.steps, microbatches=2)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    every = max(1, args.steps // 4)
    try:
        print(f"=== phase 1: train to step {args.steps // 2} ===")
        _, first = train_driver.train(
            cfg, tcfg, steps=args.steps // 2, ckpt_dir=ckpt_dir,
            ckpt_every=every, device=args.device)
        print("=== simulated failure: restart resumes from checkpoint ===")
        _, second = train_driver.train(
            cfg, tcfg, steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=every,
            resume=True, device=args.device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [r["loss"] for r in first + second]
    assert all(math.isfinite(x) for x in losses), losses
    assert second and second[0]["step"] == args.steps // 2, \
        "the restart did not resume from the last checkpoint"
    print(f"losses {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
          f"steps; resumed at step {second[0]['step']}")
    return first, second


if __name__ == "__main__":
    main()
