"""Training driver of the port, on the card by default.

Runs the data pipeline, the training loop, periodic async checkpointing of
the params, and the fault-tolerance hooks (straggler policy), as
``repro.launch.train`` does; on the CPU it runs real steps at smoke scale.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
        [--device cpu]

The flags are the reference's plus ``--device``.  ``--production-mesh``
trains on the pod mesh (:func:`repro_torch.launch.mesh.make_production_mesh`,
256 ranks started by ``torchrun``, one per card): params and batches placed
by :mod:`repro_torch.sharding`'s rules, as the reference places them.  Like
the reference, a checkpoint holds the params only, and ``--resume``
restores them into a fresh optimizer state.  :func:`train` is the loop
itself, for callers with a config of their own (a MoE dispatch strategy, a
full-width model, a mesh).
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from .. import obs
from ..checkpoint.checkpointer import Checkpointer, tree_map
from ..config import resolve_device
from ..configs import get_config
from ..configs.base import TrainConfig
from ..data.pipeline import make_batch_iterator
from ..models import build_model
from ..runtime.fault_tolerance import StragglerPolicy
from ..sharding import (abstract_like, batch_sharding, distribute,
                        params_sharding, use_mesh)
from ..train import init_train_state, make_train_step
from ..train.optimizer import adamw_init
from .mesh import make_production_mesh, process_mesh_device

__all__ = ["main", "train"]


def _gathered(tree):
    """A tree of DTensors as plain tensors, gathered on every rank."""
    return tree_map(lambda x: x.full_tensor(), tree)


def train(cfg, tcfg, *, steps, ckpt_dir=None, ckpt_every=50, resume=False,
          log_every=10, device=None, on_step=None, mesh=None):
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

    ``mesh`` (a ``DeviceMesh``) trains sharded: every rank draws the same
    init and batches, keeps its chunks as ``params_sharding`` and
    ``batch_sharding`` place them, and steps under ``use_mesh``; the
    optimizer state follows the params' placements.  Checkpoints gather
    the params on every rank and rank 0 writes them, blocking, before a
    barrier; ``resume`` restores each rank's chunks by the same
    placements.
    """
    device = process_mesh_device(mesh) if mesh is not None \
        else resolve_device(device)
    model = build_model(cfg, device=device)
    state = init_train_state(model, tcfg.seed, tcfg)
    p_shard = None
    if mesh is not None:
        p_shard = params_sharding(state.params, mesh, cfg)
        params = distribute(state.params, p_shard)
        state = state._replace(params=params, opt=adamw_init(params))
    step_fn = make_train_step(model, tcfg)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        restored, start = ckpt.restore(abstract_like(state.params),
                                       shardings=p_shard, device=device)
        state = state._replace(params=restored)
        print(f"[train] resumed from step {start}")

    def save(step, blocking=False):
        if mesh is None:
            ckpt.save(step, state.params, blocking=blocking)
            return
        params = _gathered(state.params)
        if torch.distributed.get_rank() == 0:
            ckpt.save(step, params, blocking=True)
        # no rank reads the directory before the write is complete
        torch.distributed.barrier()

    it = make_batch_iterator(cfg, tcfg, start_step=start)
    straggler = StragglerPolicy()
    history = []
    t_start = obs.now_ns()
    def placed():
        return use_mesh(mesh) if mesh is not None \
            else contextlib.nullcontext()

    try:
        for step in range(start, steps):
            batch = next(it)
            if mesh is not None:
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in batch.items()}
                batch = distribute(batch, batch_sharding(batch, mesh))
            if on_step is not None:
                on_step(step, state, batch)
            t0 = obs.now_ns()
            with placed():
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
                save(step + 1)
        if ckpt:
            save(steps, blocking=True)
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
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the (data 16, model 16) pod mesh; run "
                         "under torchrun with 256 ranks")
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
    mesh = None
    if args.production_mesh:
        if not torch.distributed.is_initialized():
            torch.distributed.init_process_group()   # torchrun's env://
        mesh = make_production_mesh(
            device_type=resolve_device(args.device).type)
    state, _ = train(cfg, tcfg, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, resume=args.resume,
                     log_every=args.log_every, device=args.device, mesh=mesh)
    return state


if __name__ == "__main__":
    main()
