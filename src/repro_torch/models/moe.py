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

The sort dispatch opens the spans ``moe.route`` (router and top-k),
``moe.permute`` (leader sort, gather, padding), ``moe.experts`` (the three
K3 calls) and ``moe.combine`` (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import obs
from ..kernels.moe_gmm import gmm, pad_groups_device
from ..sharding.act import is_dtensor, shard, sum_over_ranks
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
    return _route(torch.matmul(x.float(), p["router"]["w"].float()), top_k)


def _route(logits, top_k: int):
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


def _moe_einsum(p, cfg, x2d, group_size: int = 4096, valid=None):
    """GShard grouped dispatch: tokens split into groups of ``group_size``
    with per-(group, expert) capacity, so the dispatch buffers are
    (G, E, C, D) — linear in T.

    ``valid`` (T,): 0 at a padding token (:func:`moe_apply`).  A padding
    token takes no position in any expert's buffer and is dropped, and a
    group's capacity is the reference's for its real tokens (each group's
    count in place of ``Tg``), so real tokens drop as they would in the
    unpadded microbatch wherever its groups are this one's (one group, or
    groups of whole rows)."""
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
    if valid is None:
        flat = onehot.reshape(g_n, tg * k, e)
    else:
        real = valid.reshape(-1).long()
        if pad:
            real = F.pad(real, (0, pad), value=1)
        real = real.reshape(g_n, tg)
        flat = (onehot * real[..., None, None]).reshape(g_n, tg * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(g_n, tg, k, e)
    pos = (pos_in_expert * onehot).sum(-1)                       # (G,Tg,k)
    if valid is None:
        keep = pos < cap                                         # drops
    else:
        n = real.sum(1).double()
        cap_g = torch.clamp_min(torch.minimum(
            n, torch.floor(n * cfg.moe.capacity_factor * k / e)), 1)
        keep = (pos < cap_g[:, None, None]) & (real[..., None] > 0)
    gates = gates * keep

    # dispatch: each kept (token, slot) into its (expert, capacity) bucket;
    # dropped ones add zeros at slot 0, so the sum is order-free
    safe_pos = torch.where(keep, pos, torch.zeros_like(pos))

    def dispatch(xg, experts, safe_pos, keep):
        g_idx = torch.arange(xg.shape[0], device=xg.device)[:, None, None]
        contrib = xg[:, :, None, :] * keep[..., None].to(xg.dtype)
        expert_in = torch.zeros((xg.shape[0], e, cap, d), dtype=xg.dtype,
                                device=xg.device)
        expert_in.index_put_((g_idx.expand(experts.shape), experts,
                              safe_pos), contrib, accumulate=True)
        return expert_in

    expert_in = _by_group(dispatch, xg, experts, safe_pos, keep)

    # EP stationarity: tokens-stationary replicates the (small) expert
    # weights over DP and keeps the (G, E, C, D) buffers token-local;
    # weights-stationary moves tokens to expert shards
    layout = cfg.moe.ep_layout
    if layout == "auto":
        weight_bytes = 3 * e * d * cfg.d_ff * 2
        dispatch_bytes = 2 * g_n * tg * k * d * 2
        layout = "tokens" if weight_bytes < dispatch_bytes else "weights"
    if layout == "tokens":
        ep_spec = ("dp", None, None, "model")
    else:
        ep_spec = (None, "data", None, "model")
    expert_in = shard(expert_in, *ep_spec)
    wg, wu, wd = _weights(p, x2d.dtype)

    def experts_ffn(expert_in, wg, wu, wd):
        gg = F.silu(torch.einsum("gecd,edf->gecf", expert_in, wg))
        uu = torch.einsum("gecd,edf->gecf", expert_in, wu)
        return torch.einsum("gecf,efd->gecd", gg * uu, wd)

    expert_out = shard(_experts_placed(experts_ffn, layout, expert_in, wg,
                                       wu, wd), *ep_spec)
    # combine: gather each (token, slot)'s expert output, weight by gate
    def combine(expert_out, experts, safe_pos, weights):
        g_idx = torch.arange(expert_out.shape[0],
                             device=expert_out.device)[:, None, None]
        gathered = expert_out[g_idx.expand(experts.shape), experts,
                              safe_pos]                           # (G,Tg,k,D)
        return torch.einsum("gskd,gsk->gsd", gathered, weights)

    out = _by_group(combine, expert_out, experts, safe_pos,
                    (gates * keep).to(x2d.dtype))
    return out.reshape(g_n * tg, d)[:t]


def _experts_placed(fn, layout, expert_in, wg, wu, wd):
    """``fn(expert_in, wg, wu, wd)``, the experts' FFN on the (G, E, C, D)
    buffers.  On DTensors each rank runs it on its own shard
    (``local_map``): its groups (``layout="tokens"``) or its experts
    (``"weights"``) over the data axes, its d_ff slice over "model"; the
    weights are gathered over the data axes for tokens-stationary, and the
    output is the rank's partial sum over d_ff (``Partial`` over "model").
    DTensor's own einsum views local shards in the layout it assumes, which
    a redistributed shard need not have."""
    if not is_dtensor(expert_in):
        return fn(expert_in, wg, wu, wd)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = expert_in.device_mesh
    names = list(mesh.mesh_dim_names)
    g, e, _, _ = expert_in.shape
    f = wg.shape[2]

    def split(dim_size, axis):
        return axis in names and mesh.size(names.index(axis)) > 1 \
            and dim_size % mesh.size(names.index(axis)) == 0

    data = [a for a in ("pod", "data") if a in names
            and mesh.size(names.index(a)) > 1]
    if layout != "tokens" and not split(e, "data"):
        # experts that do not divide over the data ranks stay whole there:
        # split the groups instead, or every data rank runs them all
        layout = "tokens"
    if layout == "tokens":
        by = {a: 0 for a in data} if g % math.prod(
            mesh.size(names.index(a)) for a in data) == 0 else {}
    else:
        by = {"data": 1} if split(e, "data") else {}
    split_f = split(f, "model")

    x_pl = tuple(Shard(by[a]) if a in by else Replicate() for a in names)
    on_f = tuple(Partial() if a == "model" and split_f else p
                 for a, p in zip(names, x_pl))

    def w_pl(f_dim, grad=False):
        """A weight's placements (or its gradient's: a sum over the
        ranks' own groups where tokens-stationary splits them)."""
        return tuple(
            Shard(f_dim) if a == "model" and split_f
            else Shard(0) if a in by and layout != "tokens"
            else Partial() if a in by and grad
            else Replicate() for a in names)

    return local_map(fn, out_placements=(on_f,),
                     in_placements=(x_pl, w_pl(2), w_pl(2), w_pl(1)),
                     in_grad_placements=(on_f, w_pl(2, True), w_pl(2, True),
                                         w_pl(1, True)),
                     device_mesh=mesh, redistribute_inputs=True)(
        expert_in, wg, wu, wd)


def _by_group(fn, *ts):
    """``fn(*ts)``, each tensor's leading dim the token groups.  On DTensors
    each rank runs ``fn`` on its own groups (``local_map``): the groups
    split over the data axes where they divide, everything else whole on
    every rank, as the index dispatch and combine need (DTensor has no
    sharding rule for an accumulating ``index_put_``)."""
    if not any(is_dtensor(t) for t in ts):
        return fn(*ts)
    from torch.distributed.tensor.experimental import local_map

    from ..sharding.rules import _placements, _sanitize

    mesh = next(t for t in ts if is_dtensor(t)).device_mesh
    names = list(mesh.mesh_dim_names)
    # a mesh dim of one rank shards nothing, and DTensor will not flatten
    # the groups into tokens while they are "sharded" over it
    spec = _sanitize((tuple(a for a in ("pod", "data") if a in names
                            and mesh.size(names.index(a)) > 1),),
                     (ts[0].shape[0],), mesh)
    pl = _placements(spec, names)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,) * len(ts),
                     device_mesh=mesh, redistribute_inputs=True)(*ts)


# ---------------------------------------------------------------------------
# OP-analogue: dense compute, gate-weighted merge
# ---------------------------------------------------------------------------


def _moe_scatter(p, cfg, x2d):
    if is_dtensor(x2d):
        return _moe_local(p, cfg, x2d, _scatter_dispatch)
    gates, experts, _ = _router(p, x2d, cfg.moe.top_k)
    return _scatter_dispatch(x2d, gates, experts, _weights(p, x2d.dtype),
                             cfg.moe.num_experts)


def _scatter_dispatch(x2d, gates, experts, weights, e: int):
    """Every expert on every routed token: x2d (T, D), gates/experts
    (T, k), weights (w_gate, w_up, w_down) in the activations' dtype."""
    wg, wu, wd = weights
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
    if is_dtensor(x2d):
        return _moe_local(p, cfg, x2d, functools.partial(_sort_dispatch,
                                                         bm=bm))
    with obs.span("moe.route"):
        gates, experts, _ = _router(p, x2d, cfg.moe.top_k)
    return _sort_dispatch(x2d, gates, experts, _weights(p, x2d.dtype),
                          cfg.moe.num_experts, bm)


def _sort_dispatch(x2d, gates, experts, weights, e: int, bm: int):
    """The sort dispatch of routed tokens: x2d (T, D), gates/experts
    (T, k), weights (w_gate, w_up, w_down) in the activations' dtype."""
    t, d = x2d.shape
    k = experts.shape[1]
    dev, dt = x2d.device, x2d.dtype
    with obs.span("moe.permute"):
        flat_expert = experts.reshape(-1)                         # (T*k,)
        flat_token = torch.arange(t, device=dev).repeat_interleave(k)
        order = torch.argsort(flat_expert, stable=True)           # leader sort
        sorted_tokens = flat_token[order]
        xs = x2d[sorted_tokens]                                   # (T*k, D)
        # bincount sizes its output from the data, a host sync on the card
        group_sizes = torch.zeros(e, dtype=torch.long,
                                  device=dev).index_add_(
            0, flat_expert, torch.ones_like(flat_expert))

        # rows padded per expert to the row tile, on the device
        group_ids, scatter = pad_groups_device(group_sizes, bm, t * k)
        rows = scatter.long()
        xp = torch.zeros((group_ids.shape[0] * bm, d), dtype=dt, device=dev)
        xp.index_copy_(0, rows, xs)
    wg, wu, wd = weights
    f = wg.shape[2]
    with obs.span("moe.experts"):
        # bk and bn are the reference's tiling of K and N; whole extents
        # always divide, and the kernel's result does not depend on them
        g = F.silu(gmm(xp, wg, group_ids, bm=bm, bk=d, bn=f, out_dtype=dt))
        u = gmm(xp, wu, group_ids, bm=bm, bk=d, bn=f, out_dtype=dt)
        yp = gmm(g * u, wd, group_ids, bm=bm, bk=f, bn=d, out_dtype=dt)
    with obs.span("moe.combine"):
        ys = yp[rows]                                             # (T*k, D)
        flat_gates = gates.reshape(-1)[order].to(dt)
        contrib = ys * flat_gates[:, None]

        # deterministic combine: token i's k contributions sit at the
        # sorted positions inv[i*k:(i+1)*k]; add them in ascending
        # position, the order of JAX's out.at[sorted_tokens].add
        inv = torch.empty_like(order)
        inv[order] = torch.arange(t * k, device=dev)
        at = inv.reshape(t, k).sort(dim=1).values
        out = torch.zeros_like(x2d)
        for j in range(k):
            out = out + contrib[at[:, j]]
    return out


def _moe_local(p, cfg, x2d, dispatch):
    """A dropless dispatch on DTensors, ``dispatch(x, gates, experts,
    weights, e)`` (:func:`_sort_dispatch`: sort, padding, K3 and the
    combine; or :func:`_scatter_dispatch`): it and the router run on each
    rank's local tensors (``local_map``).

    Tokens stay where they are on the data axes (tokens-stationary: the
    expert weights are gathered over them, as the reference's
    ``ep_layout="tokens"``).  Where "model" splits d_ff, each rank holds its
    slice of ``w_gate``/``w_up``/``w_down``, runs the dispatch on it, and its
    output is its partial sum over d_ff (``Partial`` over "model").  The
    router's columns (experts) are then split over "model" too; the top-k
    needs the whole (T, E) logits, which each rank assembles exactly from
    its columns padded with zeros and one ``all_reduce`` (adding zeros is
    exact, and gloo takes ``all_reduce`` on CUDA tensors, where it takes no
    ``all_gather``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x2d.device_mesh
    names = list(mesh.mesh_dim_names)
    m_dim = names.index("model") if "model" in names else None
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    router = p["router"]["w"]

    def on_model(t, dim):
        return m_dim is not None and t.placements[m_dim] == Shard(dim)

    split_f = on_model(p["w_gate"], 2)
    split_e = split_f and on_model(router, 1)

    # tokens: row shards over the data axes as they come, whole over model
    x_pl = tuple(pl if i != m_dim and pl == Shard(0) else Replicate()
                 for i, pl in enumerate(x2d.placements))
    x_grad = tuple(Partial() if i == m_dim and split_f else pl
                   for i, pl in enumerate(x_pl))

    def placed(dim, split):
        """A weight in the block, and its gradient: sharded on ``dim``
        over "model" where ``split``; gathered over the data axes, where a
        gradient sums over the ranks' own tokens."""
        at = tuple(Shard(dim) if i == m_dim and split else Replicate()
                   for i in range(mesh.ndim))
        grad = tuple(Shard(dim) if i == m_dim and split
                     else Partial() if (i == m_dim and split_f)
                     or x_pl[i] == Shard(0) else Replicate()
                     for i in range(mesh.ndim))
        return at, grad

    w = [placed(1, split_e), placed(2, split_f), placed(2, split_f),
         placed(1, split_f)]

    def block(x, router_w, wg, wu, wd):
        logits = torch.matmul(x.float(), router_w.float())
        if split_e:
            rank = mesh.get_local_rank("model")
            e_loc = logits.shape[1]
            # each rank's gradient of the logits is its partial sum (from
            # its d_ff slice), so the backward sums it over "model" again
            logits = sum_over_ranks(
                F.pad(logits, (rank * e_loc, e - (rank + 1) * e_loc)),
                mesh.get_group("model"))
        with obs.span("moe.route"):
            gates, experts, _ = _route(logits, k)
        dt = x.dtype
        return dispatch(x, gates, experts, (wg.to(dt), wu.to(dt), wd.to(dt)),
                        e)

    out_pl = tuple(Partial() if i == m_dim and split_f else pl
                   for i, pl in enumerate(x_pl))
    fn = local_map(block, out_placements=(out_pl,),
                   in_placements=(x_pl,) + tuple(at for at, _ in w),
                   in_grad_placements=(x_grad,) + tuple(g for _, g in w),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x2d, router, p["w_gate"], p["w_up"], p["w_down"])


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
              plan: Optional[MoEPlan] = None, valid=None):
    """x: (B, S, D) -> (B, S, D).

    ``plan`` (from :func:`plan_moe`) skips the per-call strategy selection.
    ``valid`` (B, S): 0 at the tokens of a padding row (a microbatch padded
    over the data ranks, :func:`repro_torch.train.trainer.loss_and_grads`).
    Under ``einsum`` they take no capacity from real tokens; ``sort`` and
    ``scatter`` have no capacity, and a padding token only costs work
    there (the loss masks its output).
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
        out = _moe_einsum(p, cfg, x2d, valid=valid)
    elif strat == "scatter":
        out = _moe_scatter(p, cfg, x2d)
    elif strat == "sort":
        out = _moe_sort(p, cfg, x2d)
    else:
        raise ValueError(f"unknown moe strategy {strat!r}")
    return out.reshape(b, s, d).to(x.dtype)
