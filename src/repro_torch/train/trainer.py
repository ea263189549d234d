"""Training step factory: microbatched gradient accumulation, remat,
mixed precision, gradient clipping, optional int8 gradient compression with
error feedback, cosine LR.

The port of ``repro.train.trainer``.  Gradients come from autograd over the
parameter leaves; on the card a ``sort`` MoE layer's expert products run
K3 forward and backward and K3w for the weight gradient
(:class:`repro_torch.kernels.moe_gmm.GroupedMatmul`).  After the gradients
the step runs, in the reference's order: compression, clipping, the LR of
the pre-increment step, AdamW.  The metrics stay on the device: reading
one waits for the step.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..checkpoint.checkpointer import tree_flatten, tree_map, tree_unflatten
from ..sharding.act import is_dtensor
from .compression import compress_decompress, init_error_feedback
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, cosine_schedule, decay_mask)

__all__ = ["TrainState", "init_train_state", "loss_and_grads",
           "make_train_step"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[Any]           # error-feedback residuals (compression)


def init_train_state(model, seed: int, tcfg) -> TrainState:
    """Params from ``seed`` on the model's device: fp32 master weights, or
    bf16 under ``param_dtype="bfloat16"``; the moments are fp32 either way."""
    dtype = (torch.bfloat16 if getattr(tcfg, "param_dtype", "float32")
             == "bfloat16" else torch.float32)
    params = model.init(seed=seed, dtype=dtype)
    return TrainState(
        params=params,
        opt=adamw_init(params),
        ef=init_error_feedback(params) if tcfg.grad_compression else None,
    )


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    # a batch placed on a mesh (DTensors) is where it belongs already
    return {k: v if is_dtensor(v) else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's whole value)."""
    return x.full_tensor() if is_dtensor(x) else x


def _value_and_grad(model, params, batch, remat):
    """(loss, grads): autograd over every leaf of ``params``; a leaf the
    loss does not reach gets a zero gradient."""
    leaves = tree_flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    with torch.enable_grad():
        loss, _ = model.loss(tree_unflatten(params, live), batch,
                             remat=remat)
        wrt = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), tree_unflatten(params, grads)


def _microbatch(v, i: int, m: int):
    """Microbatch ``i`` of ``m`` along the leading axis.

    A DTensor batch sharded along it gives each rank its own rows' ``i``-th
    chunk (when they divide), so a microbatch stays sharded as the batch
    is; a slice of the global rows would gather them onto every rank.  The
    microbatches then hold other rows than the global chunks, and the
    accumulated gradient the same rows in another order."""
    if is_dtensor(v):
        from torch.distributed.tensor import DTensor, Shard

        local = v.to_local()
        if any(p == Shard(0) for p in v.placements) \
                and local.shape[0] % m == 0:
            size = local.shape[0] // m
            return DTensor.from_local(local[i * size:(i + 1) * size],
                                      v.device_mesh, v.placements,
                                      run_check=False)
    size = v.shape[0] // m
    return v[i * size:(i + 1) * size]


def loss_and_grads(model, tcfg, params, batch):
    """The step's loss and gradients.  ``tcfg.microbatches`` splits the
    batch's leading axis into equal chunks (:func:`_microbatch`) whose
    gradients are summed in fp32 in order and scaled by 1/m, as the
    reference's ``lax.scan`` does; with one microbatch the gradients keep
    the parameters' dtype."""
    batch = _on_device(batch, model.device)
    m = tcfg.microbatches
    if m == 1:
        return _value_and_grad(model, params, batch, tcfg.remat)
    g_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    l_sum = 0.0
    for i in range(m):
        mb = {k: _microbatch(v, i, m) for k, v in batch.items()}
        loss, grads = _value_and_grad(model, params, mb, tcfg.remat)
        g_sum = tree_map(lambda a, g: a + g.float(), g_sum, grads)
        l_sum = l_sum + loss
    inv = 1.0 / m
    return l_sum * inv, tree_map(lambda g: g * inv, g_sum)


def make_train_step(model, tcfg):
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch: {"tokens": (B, S), "targets": (B, S), ...} as numpy arrays or
    tensors, B = the global batch.  ``metrics`` holds 0-d tensors on the
    device: ``loss``, ``grad_norm``, ``lr`` and ``step`` (the new step).
    The weight-decay mask is built from the first state's params and kept.
    """
    decay = []

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        if not decay:
            decay.append(decay_mask(state.params))
        loss, grads = loss_and_grads(model, tcfg, state.params, batch)

        ef = state.ef
        if ef is not None:
            grads, ef = compress_decompress(grads, ef)

        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = cosine_schedule(state.opt.step, base_lr=tcfg.lr,
                             warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                   weight_decay=tcfg.weight_decay,
                                   decay=decay[0])
        metrics = {"loss": _whole(loss), "grad_norm": _whole(gnorm),
                   "lr": lr, "step": opt.step}
        return TrainState(params, opt, ef), metrics

    return step
