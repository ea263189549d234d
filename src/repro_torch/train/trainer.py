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

A step opens the ``repro_torch.obs`` spans ``train.step``,
``train.forward`` and ``train.backward`` (each microbatch's) and
``train.optimizer`` (clipping, the schedule and AdamW).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import obs
from ..checkpoint.checkpointer import tree_flatten, tree_map, tree_unflatten
from ..sharding.act import gather_data, gathered_params, is_dtensor
from .compression import compress_decompress, init_error_feedback
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, cosine_schedule, decay_mask)

__all__ = ["TrainState", "init_train_state", "loss_and_grads",
           "make_train_step", "microbatch_rows"]


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


def _value_and_grad(model, params, batch, remat, gather=False):
    """(loss, grads): autograd over every leaf of ``params``; a leaf the
    loss does not reach gets a zero gradient.  ``gather``: the model sees
    each DTensor leaf gathered over the data axes (:func:`gather_data`),
    and its gradient comes back to the leaf's shards."""
    leaves = tree_flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    placed = gathered_params() if gather else contextlib.nullcontext()
    with torch.enable_grad(), placed:
        with obs.span("train.forward"):
            used = [gather_data(p) for p in live] if gather else live
            loss, _ = model.loss(tree_unflatten(params, used), batch,
                                 remat=remat)
        wrt = [p for p in live if p.requires_grad]
        with obs.span("train.backward"):
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), tree_unflatten(params, grads)


def _data_rank(v) -> Tuple[int, int]:
    """(this rank's index, the count) among the ranks that split the rows
    of ``v`` (a DTensor sharded along its leading axis): the mesh dims that
    shard it, outermost first, as DTensor orders their shards."""
    from torch.distributed.tensor import Shard

    mesh, coord = v.device_mesh, v.device_mesh.get_coordinate()
    r, dp = 0, 1
    for d, pl in enumerate(v.placements):
        if pl == Shard(0):
            r, dp = r * mesh.size(d) + coord[d], dp * mesh.size(d)
    return r, dp


def _local_rows(i: int, n: int, dp: int, r: int) -> Tuple[int, int]:
    """The local rows ``[lo, hi)`` that data rank ``r`` gives microbatch
    ``i`` of ``n`` rows: local row ``k`` of rank ``r`` is row ``k * dp + r``
    of a rank-interleaved order, and microbatch ``i`` takes that order's
    rows ``[i * n, (i + 1) * n)``, at most ``ceil(n / dp)`` a rank."""
    return -((r - i * n) // dp), -((r - (i + 1) * n) // dp)


def microbatch_rows(b: int, m: int, dp: int) -> List[List[int]]:
    """The global rows of each of the ``m`` microbatches that
    :func:`loss_and_grads` forms from a batch of ``b`` rows sharded over
    ``dp`` data ranks, in the order the microbatch holds them (rank by
    rank).  An unsharded step over ``batch[sum(rows, [])]`` forms the same
    microbatches (``rows`` this list)."""
    n, local = b // m, b // dp
    if local % m == 0:
        size = local // m
        return [[r * local + i * size + j for r in range(dp)
                 for j in range(size)] for i in range(m)]
    return [[r * local + k for r in range(dp)
             for k in range(*_local_rows(i, n, dp, r))] for i in range(m)]


def _padded_microbatches(batch, m: int, dp: int, r: int):
    """The ``m`` microbatches of a batch of DTensors whose local rows do
    not divide into ``m``: each rank builds its part of microbatch ``i``
    from its own rows (:func:`_local_rows`), padded to ``ceil(b/m/dp)``
    rows with copies of its first row, with no collective.  A padding row
    carries ``mask = 0`` (the loss's token mask, made of ones where the
    batch has none) and ``valid = 0`` (the tokens' own mask: padding takes
    no MoE capacity), so each microbatch's loss is the mean over its real
    rows, as GSPMD's padded shards of the reference's microbatch give."""
    from torch.distributed.tensor import DTensor

    ref = batch["targets"]
    n = ref.shape[0] // m
    per_rank = -(-n // dp)
    local = {k: v.to_local() for k, v in batch.items()}
    ones = torch.ones(local["targets"].shape, dtype=torch.float32,
                      device=local["targets"].device)
    out = []
    for i in range(m):
        lo, hi = _local_rows(i, n, dp, r)
        pad = per_rank - (hi - lo)

        def rows(t, fill=None):
            extra = (t[:1].expand((pad,) + t.shape[1:]) if fill is None
                     else t.new_full((pad,) + t.shape[1:], fill))
            return torch.cat([t[lo:hi], extra])

        mb = {k: rows(t) for k, t in local.items() if k != "mask"}
        mb["valid"] = rows(ones, 0.0)
        mb["mask"] = rows(local["mask"], 0) if "mask" in local \
            else mb["valid"]
        out.append({k: DTensor.from_local(t, ref.device_mesh,
                                          ref.placements, run_check=False)
                    for k, t in mb.items()})
    return out


def _microbatches(batch, m: int):
    """The batch's ``m`` microbatches along the leading axis.

    A DTensor batch sharded along it stays sharded: with local rows that
    divide into ``m``, each rank's microbatch ``i`` is its own rows' ``i``-th
    chunk; otherwise each rank pads its share of a microbatch's rows to
    the same count (:func:`_padded_microbatches`).  A slice of the global
    rows would gather them onto every rank.  The microbatches then hold
    other rows than the global chunks (:func:`microbatch_rows`), and the
    accumulated gradient the same rows in another order."""
    ref = batch["targets"]
    if is_dtensor(ref):
        from torch.distributed.tensor import DTensor, Shard

        if any(p == Shard(0) for p in ref.placements):
            r, dp = _data_rank(ref)
            if ref.to_local().shape[0] % m:
                return _padded_microbatches(batch, m, dp, r)

            def chunk(v, i):
                local = v.to_local()
                size = local.shape[0] // m
                return DTensor.from_local(local[i * size:(i + 1) * size],
                                          v.device_mesh, v.placements,
                                          run_check=False)

            return [{k: chunk(v, i) for k, v in batch.items()}
                    for i in range(m)]
    size = ref.shape[0] // m
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(m)]


def loss_and_grads(model, tcfg, params, batch):
    """The step's loss and gradients.  ``tcfg.microbatches`` splits the
    batch's leading axis into equal chunks (:func:`_microbatches`) whose
    gradients are summed in fp32 in order and scaled by 1/m, as the
    reference's ``lax.scan`` does; with one microbatch the gradients keep
    the parameters' dtype.  A padded microbatch runs on the params
    gathered over the data axes, its products placed on its rows' shards
    (``sharding.act.gathered_params``): DTensor's own strategies would
    move its rows onto every data rank."""
    batch = _on_device(batch, model.device)
    m = tcfg.microbatches
    if m == 1:
        return _value_and_grad(model, params, batch, tcfg.remat)
    g_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    l_sum = 0.0
    for mb in _microbatches(batch, m):
        loss, grads = _value_and_grad(model, params, mb, tcfg.remat,
                                      gather="valid" in mb)
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
        with obs.span("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        if not decay:
            decay.append(decay_mask(state.params))
        loss, grads = loss_and_grads(model, tcfg, state.params, batch)

        ef = state.ef
        if ef is not None:
            grads, ef = compress_decompress(grads, ef)

        with obs.span("train.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            lr = cosine_schedule(state.opt.step, base_lr=tcfg.lr,
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
            params, opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                       weight_decay=tcfg.weight_decay,
                                       decay=decay[0])
        metrics = {"loss": _whole(loss), "grad_norm": _whole(gnorm),
                   "lr": lr, "step": opt.step}
        return TrainState(params, opt, ef), metrics

    return step
