"""AdamW + schedules on tensor trees, hand-rolled as in the reference.

The port of ``repro.train.optimizer``: plain functions under
``torch.no_grad()``, with the reference's formulas in the reference's order
(``torch.optim.AdamW`` applies its decay elsewhere and hides the rule in
parameter groups).  Moments are fp32 whatever the parameters' dtype; every
update returns new tensors, as JAX's does.

Weight decay follows JAX's layout.  The reference decays a leaf when its
rank is at least 2; JAX stacks each layer's leaves along a leading layer
axis, so a per-layer norm scale is ``(L, d)`` there and is decayed, while
the port keeps one dict per layer (a list in the tree) and its scale is
``(d,)``.  :func:`decay_mask` therefore counts one extra rank for a leaf
under a list: the leaves it decays are exactly those whose JAX counterpart
has rank >= 2.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..checkpoint.checkpointer import tree_flatten, tree_map, tree_unflatten

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "decay_mask", "global_norm", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        # zeros_like keeps a DTensor leaf's mesh and placements
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        p)

    leaves = tree_flatten(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros(params), v=zeros(params))


def decay_mask(params):
    """A tree of bools beside ``params``: True where AdamW decays the leaf,
    i.e. where its rank, plus one under a list (the layer axis JAX stacks
    each list into), is at least 2."""
    def mask(x, stacked):
        if isinstance(x, dict):
            return {k: mask(v, stacked) for k, v in x.items()}
        if isinstance(x, list):
            return [mask(v, True) for v in x]
        return x.dim() + int(stacked) >= 2

    return mask(params, False)


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, final_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor, kept on its device)."""
    step = step.float()
    warm = base_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                * prog))
    return torch.where(step < warmup, warm, base_lr * cos)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_flatten(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, decay: Optional[Any] = None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step; ``decay`` is :func:`decay_mask`'s tree (built from
    ``params`` when not given)."""
    step = state.step + 1
    t = step.float()
    decay = decay_mask(params) if decay is None else decay

    def upd(p, g, m, v, dec):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        delta = mh / (torch.sqrt(vh) + eps)
        if dec:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(
        tree_flatten(params), tree_flatten(grads), tree_flatten(state.m),
        tree_flatten(state.v), tree_flatten(decay))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
