"""Training driver of the port, on the card by default.

Runs the data pipeline, the training loop, periodic async checkpointing of
the params, and the fault-tolerance hooks (straggler policy), as
``repro.launch.train`` does; on the CPU it runs real steps at smoke scale.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
        [--device cpu]

The flags are the reference's plus ``--device``; its ``--production-mesh``
(a TPU fleet's mesh) is not ported.  Like the reference, a checkpoint holds
the params only, and ``--resume`` restores them into a fresh optimizer
state.  :func:`train` is the loop itself, for callers with a config of their
own (a MoE dispatch strategy, a full-width model).
"""
from __future__ import annotations

import argparse

import torch

from .. import obs
from ..checkpoint.checkpointer import Checkpointer, tree_map
from ..config import resolve_device
from ..configs import get_config
from ..configs.base import TrainConfig
from ..data.pipeline import make_batch_iterator
from ..models import build_model
from ..runtime.fault_tolerance import StragglerPolicy
from ..train import init_train_state, make_train_step

__all__ = ["main", "train"]


def train(cfg, tcfg, *, steps, ckpt_dir=None, ckpt_every=50, resume=False,
          log_every=10, device=None, on_step=None):
    """Train ``cfg`` under ``tcfg`` up to step ``steps``; returns
    ``(state, history)``.

    ``history`` has one dict per step run: ``step``, ``loss``,
    ``grad_norm``, ``lr`` and ``dt`` (seconds).  A step's ``dt`` is taken
    after ``torch.cuda.synchronize()``, one sync per step, so that it
    measures the step and not its enqueue; the straggler policy reads it.
    With ``ckpt_dir`` the params are saved (async) every ``ckpt_every``
    steps and at the end; ``resume`` restores the latest saved params and
    starts the data stream at their step.  ``on_step(step, state, batch)``,
    if given, sees each step's input state and batch before the step runs.
    """
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    state = init_train_state(model, tcfg.seed, tcfg)
    step_fn = make_train_step(model, tcfg)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        like = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), state.params)
        restored, start = ckpt.restore(like, device=device)
        state = state._replace(params=restored)
        print(f"[train] resumed from step {start}")

    it = make_batch_iterator(cfg, tcfg, start_step=start)
    straggler = StragglerPolicy()
    history = []
    t_start = obs.now_ns()
    try:
        for step in range(start, steps):
            batch = next(it)
            if on_step is not None:
                on_step(step, state, batch)
            t0 = obs.now_ns()
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = (obs.now_ns() - t0) / 1e9
            verdict = straggler.observe(dt)
            if verdict != "ok":
                print(f"[straggler] step {step}: {dt:.2f}s -> {verdict}")
            row = {"step": step, "dt": dt,
                   **{k: float(metrics[k]) for k in ("loss", "grad_norm",
                                                     "lr")}}
            history.append(row)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step} loss={row['loss']:.4f} "
                      f"gnorm={row['grad_norm']:.3f} "
                      f"lr={row['lr']:.2e} {dt*1e3:.0f}ms")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state.params)
        if ckpt:
            ckpt.save(steps, state.params, blocking=True)
    finally:
        it.close()
    tok_s = (steps - start) * tcfg.global_batch * tcfg.seq_len \
        / ((obs.now_ns() - t_start) / 1e9)
    print(f"[train] done: {tok_s:.0f} tokens/s "
          f"(straggler skips: {straggler.skipped})")
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card (cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                       warmup_steps=max(1, args.steps // 10),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression)
    state, _ = train(cfg, tcfg, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, resume=args.resume,
                     log_every=args.log_every, device=args.device)
    return state


if __name__ == "__main__":
    main()
