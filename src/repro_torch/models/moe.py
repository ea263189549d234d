"""Mixture-of-Experts with three selectable dispatch dataflows.

The port of ``repro.models.moe``.  MoE dispatch is SpMSpM (the routing
matrix is sparse); the three strategies are the paper's three loop orders:

- ``einsum``  (IP-analogue): capacity-based GShard dispatch.  Tokens beyond
  expert capacity drop.
- ``scatter`` (OP-analogue): every expert processes every token, outputs
  merged by gate weight.  Dropless; plain ``torch.einsum``, no kernel.
- ``sort``    (Gust-analogue): tokens sorted by expert (leader-follower),
  then one grouped GEMM per projection on kernel K3
  (:func:`repro_torch.kernels.moe_gmm.gmm`).  Dropless.

``strategy="auto"`` picks per layer shape with a cost model (phase 1).

Where JAX's ``_moe_sort`` runs ``jax.lax.ragged_dot`` on the sorted rows,
the port pads each expert's rows to the row tile :data:`SORT_BM` on the
device (:func:`~repro_torch.kernels.moe_gmm.pad_groups_device`, no host
sync), runs K3 three times (gate, up, down), and takes the real rows back
through the scatter index.  K3 is differentiable
(:class:`~repro_torch.kernels.moe_gmm.GroupedMatmul`: K3 on the transposed
weights for the input's gradient, K3w for the weights'), and the padding,
scatter and combine are differentiable torch ops, so a training step's
gradient reaches the input, the router and the three expert weights, as
JAX's through ``ragged_dot``.  The combine is deterministic: each token's k
weighted expert outputs are gathered through the inverse of the sort and
added one by one in the order JAX's scatter-add applies them (ascending
expert), in the activations' dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm import gmm, pad_groups_device
from .layers import dense_init, normal

__all__ = ["moe_init", "moe_apply", "select_moe_strategy", "MoEPlan",
           "plan_moe", "STRATEGY_OF_DATAFLOW", "SORT_BM"]

#: K3's row tile on the sort path.  Decode routes slots x top-k rows over
#: the experts (32 rows over 32 experts at granite's width with 4 slots),
#: so a small tile wastes few rows: 16 pads them to at most 34 tiles where
#: the TPU's 128 would need up to 32 x 128 rows.
SORT_BM = 16


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    scale = 1.0 / math.sqrt(d)
    return {
        "router": dense_init(gen, d, e, scale=scale, dtype=dtype),
        "w_gate": normal(gen, (e, d, f), scale, dtype),
        "w_up": normal(gen, (e, d, f), scale, dtype),
        "w_down": normal(gen, (e, f, d), 1.0 / math.sqrt(f), dtype),
    }


def _router(p, x, top_k: int):
    """x: (T, D) -> (gates (T, k), experts (T, k), probs (T, E))."""
    logits = torch.matmul(x.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, experts, probs


def _expert_ffn(w_gate, w_up, w_down, x):
    """x: (..., E, D) with expert-major leading axes on the weights."""
    g = F.silu(torch.einsum("...ed,edf->...ef", x, w_gate))
    u = torch.einsum("...ed,edf->...ef", x, w_up)
    return torch.einsum("...ef,efd->...ed", g * u, w_down)


def _weights(p, dtype):
    return (p["w_gate"].to(dtype), p["w_up"].to(dtype), p["w_down"].to(dtype))


# ---------------------------------------------------------------------------
# IP-analogue: capacity-based one-hot dispatch (GShard)
# ---------------------------------------------------------------------------


def _moe_einsum(p, cfg, x2d, group_size: int = 4096):
    """GShard grouped dispatch: tokens split into groups of ``group_size``
    with per-(group, expert) capacity, so the dispatch buffers are
    (G, E, C, D) — linear in T."""
    t, d = x2d.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    tg = min(group_size, t)
    g_n = -(-t // tg)
    pad = g_n * tg - t
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad))
    xg = x2d.reshape(g_n, tg, d)                                 # (G, Tg, D)
    cap = max(1, min(tg, int(cfg.moe.capacity_factor * tg * k / e)))

    gates, experts, _ = _router(p, x2d, k)
    gates = gates.reshape(g_n, tg, k)
    experts = experts.reshape(g_n, tg, k)

    # position of each (token, slot) within its (group, expert) buffer
    onehot = F.one_hot(experts, e)                               # (G,Tg,k,E)
    flat = onehot.reshape(g_n, tg * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(g_n, tg, k, e)
    pos = (pos_in_expert * onehot).sum(-1)                       # (G,Tg,k)
    keep = pos < cap                                             # drops
    gates = gates * keep

    # dispatch: each kept (token, slot) into its (expert, capacity) bucket;
    # dropped ones add zeros at slot 0, so the sum is order-free
    g_idx = torch.arange(g_n, device=x2d.device)[:, None, None].expand(
        experts.shape)
    contrib = xg[:, :, None, :] * keep[..., None].to(x2d.dtype)
    safe_pos = torch.where(keep, pos, torch.zeros_like(pos))
    expert_in = torch.zeros((g_n, e, cap, d), dtype=x2d.dtype,
                            device=x2d.device)
    expert_in.index_put_((g_idx, experts, safe_pos), contrib, accumulate=True)
    wg, wu, wd = _weights(p, x2d.dtype)
    gg = F.silu(torch.einsum("gecd,edf->gecf", expert_in, wg))
    uu = torch.einsum("gecd,edf->gecf", expert_in, wu)
    expert_out = torch.einsum("gecf,efd->gecd", gg * uu, wd)
    # combine: gather each (token, slot)'s expert output, weight by gate
    gathered = expert_out[g_idx, experts, safe_pos]               # (G,Tg,k,D)
    weights = (gates * keep).to(x2d.dtype)
    out = torch.einsum("gskd,gsk->gsd", gathered, weights)
    return out.reshape(g_n * tg, d)[:t]


# ---------------------------------------------------------------------------
# OP-analogue: dense compute, gate-weighted merge
# ---------------------------------------------------------------------------


def _moe_scatter(p, cfg, x2d):
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    gates, experts, _ = _router(p, x2d, k)
    wg, wu, wd = _weights(p, x2d.dtype)
    # every (token, expert) partial product, then merge by gate weight
    g = F.silu(torch.einsum("td,edf->tef", x2d, wg))
    u = torch.einsum("td,edf->tef", x2d, wu)
    outs = torch.einsum("tef,efd->ted", g * u, wd)                # (T, E, D)
    combine = torch.sum(F.one_hot(experts, e).to(x2d.dtype)
                        * gates[..., None].to(x2d.dtype), dim=1)  # (T, E)
    return torch.einsum("ted,te->td", outs, combine)


# ---------------------------------------------------------------------------
# Gust-analogue: sort by expert + grouped GEMM on K3 (dropless)
# ---------------------------------------------------------------------------


def _moe_sort(p, cfg, x2d, bm: int = SORT_BM):
    t, d = x2d.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    dev, dt = x2d.device, x2d.dtype
    gates, experts, _ = _router(p, x2d, k)
    flat_expert = experts.reshape(-1)                             # (T*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)               # leader sort
    sorted_tokens = flat_token[order]
    xs = x2d[sorted_tokens]                                       # (T*k, D)
    # bincount sizes its output from the data, a host sync on the card
    group_sizes = torch.zeros(e, dtype=torch.long, device=dev).index_add_(
        0, flat_expert, torch.ones_like(flat_expert))

    # rows padded per expert to the row tile, on the device
    group_ids, scatter = pad_groups_device(group_sizes, bm, t * k)
    rows = scatter.long()
    xp = torch.zeros((group_ids.shape[0] * bm, d), dtype=dt, device=dev)
    xp.index_copy_(0, rows, xs)
    wg, wu, wd = _weights(p, dt)
    f = wg.shape[2]
    # bk and bn are the reference's tiling of K and N; whole extents
    # always divide, and the kernel's result does not depend on them
    g = F.silu(gmm(xp, wg, group_ids, bm=bm, bk=d, bn=f, out_dtype=dt))
    u = gmm(xp, wu, group_ids, bm=bm, bk=d, bn=f, out_dtype=dt)
    yp = gmm(g * u, wd, group_ids, bm=bm, bk=f, bn=d, out_dtype=dt)
    ys = yp[rows]                                                 # (T*k, D)
    flat_gates = gates.reshape(-1)[order].to(dt)
    contrib = ys * flat_gates[:, None]

    # deterministic combine: token i's k contributions sit at the sorted
    # positions inv[i*k:(i+1)*k]; add them in ascending position, the order
    # of JAX's out.at[sorted_tokens].add
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    at = inv.reshape(t, k).sort(dim=1).values
    out = torch.zeros_like(x2d)
    for j in range(k):
        out = out + contrib[at[:, j]]
    return out


def select_moe_strategy(t: int, d: int, f: int, e: int, k: int) -> str:
    """Cost-model strategy choice (phase-1 analogue for MoE layers).

    scatter flops ≈ e/k × useful; einsum adds dispatch one-hot matmuls
    O(T·E·C·D) and risks drops; sort adds O(T·k log T·k) sort + gather but
    is dropless and flop-minimal.
    """
    useful = 6 * t * k * d * f                     # gate+up+down per token
    scatter_cost = useful * (e / max(1, k))
    cap = 1.25 * t * k / e
    einsum_cost = useful + 2 * t * e * cap * d * 2
    sort_cost = useful * 1.05 + 64 * t * k * math.log2(max(2, t * k))
    costs = {"scatter": scatter_cost, "einsum": einsum_cost,
             "sort": sort_cost}
    return min(costs, key=costs.get)


@dataclasses.dataclass(frozen=True)
class MoEPlan:
    """Phase-1 output for one MoE layer shape: the dispatch strategy, chosen
    once and reused for every execution with the same token count."""

    strategy: str
    tokens: int


#: Each MoE dispatch strategy is one of the paper's dataflows deployed —
#: the mapping a dataflow-selection policy goes through when it plans MoE
#: dispatch.
STRATEGY_OF_DATAFLOW = {"ip": "einsum", "op": "scatter", "gust": "sort"}


def plan_moe(cfg, tokens: int, *, strategy: Optional[str] = None,
             policy=None) -> MoEPlan:
    """Run the MoE strategy selector once for this token shape.

    ``policy`` (a :class:`repro_torch.backends.SelectionPolicy`) swaps the
    selector: the policy picks a *dataflow* for the layer's shape features
    and the choice maps through the strategy↔dataflow analogy
    (IP→einsum, OP→scatter, Gust→sort).  Default: the MoE-specific cost
    model (:func:`select_moe_strategy`).
    """
    strat = strategy or cfg.moe.strategy
    if strat == "auto":
        if policy is not None:
            from ..core.selector import LayerShape

            shape = LayerShape(m=tokens, k=cfg.d_model, n=cfg.d_ff,
                               density_a=1.0,
                               density_b=cfg.moe.top_k / cfg.moe.num_experts)
            chosen = policy.select_for_shape(shape)
            strat = STRATEGY_OF_DATAFLOW[chosen[:-2]]
        else:
            strat = select_moe_strategy(tokens, cfg.d_model, cfg.d_ff,
                                        cfg.moe.num_experts, cfg.moe.top_k)
    return MoEPlan(strategy=strat, tokens=tokens)


def moe_apply(p, cfg, x, *, strategy: Optional[str] = None,
              plan: Optional[MoEPlan] = None):
    """x: (B, S, D) -> (B, S, D).

    ``plan`` (from :func:`plan_moe`) skips the per-call strategy selection.
    """
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if plan is not None:
        strat = plan.strategy
    else:
        strat = strategy or cfg.moe.strategy
        if strat == "auto":
            strat = select_moe_strategy(b * s, d, cfg.d_ff,
                                        cfg.moe.num_experts, cfg.moe.top_k)
    if strat == "einsum":
        out = _moe_einsum(p, cfg, x2d)
    elif strat == "scatter":
        out = _moe_scatter(p, cfg, x2d)
    elif strat == "sort":
        out = _moe_sort(p, cfg, x2d)
    else:
        raise ValueError(f"unknown moe strategy {strat!r}")
    return out.reshape(b, s, d).to(x.dtype)
