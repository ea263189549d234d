"""A plain reference of granite-moe-1b-a400m's training step: its loss, its
gradients and its AdamW update.

Plain ``torch`` in float32 with TF32 off, written from the published
description (ibm-granite/granite-3.0-1b-a400m-base): token embedding times
``embedding_multiplier``; each of the layers a pre-norm block of grouped-
query attention with rotary positions (rotate-half, ``rope_theta``), its
softmax over the causal scores times ``attention_multiplier``, and a
sparse-expert block whose router keeps the top ``top_k`` logits of each
token and weights its experts by the softmax over them, each expert a
SwiGLU; each branch times ``residual_multiplier`` before it is added; a
final RMSNorm (``rms_norm_eps``) and the tied embedding as the output head,
the logits divided by ``logits_scaling``; the loss the mean next-token
cross entropy over every token of the batch.

It computes attention naively (the whole causal score matrix of a head),
every expert by a loop over the rows routed to it, and the gradients by
autograd on its own forward, one sequence at a time and one layer at a
time under ``torch.utils.checkpoint``, so that it fits on one card at the
published width.  It imports no module of the program: it reads the
parameters as a tree of dicts and lists of tensors, under the names the
program gives them, and the architecture as a dict (:data:`ARCH_KEYS`).
Departures from the published model: no load-balancing auxiliary loss, no
dropout.

``routes`` pins each layer's experts to those a program chose: the
gates are still the softmax over the reference's own logits at those
experts, and ``route_gap`` says how far the choice departs from the
reference's top ``top_k`` (:func:`loss_and_grads`).  A program in lower
precision routes a token otherwise than the reference wherever its 8th
and 9th logits nearly tie, and such a token's gradient differs by far
more than rounding; pinned, the two compute the same sums.

``rounded`` replaces the value of every matrix product's inputs (their
gradient passes through unchanged): the control, which computes the same
loss in a lower precision, rounds them through ``torch.float8_e4m3fn``
(:func:`float8_inputs`).

:func:`adamw_step` is the optimizer as ``config.json``'s training recipe
states it: clipping by the global norm, a linear warm-up then a cosine
decay of the learning rate, and AdamW with bias correction, decaying
every matrix and every per-layer leaf; computed in float64, the new
parameters rounded to float32.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the architecture's keys, as the published ``config.json`` names them
ARCH_KEYS = ("hidden_size", "num_attention_heads", "num_key_value_heads",
             "head_dim", "rope_theta", "rms_norm_eps", "num_local_experts",
             "num_experts_per_tok", "embedding_multiplier",
             "attention_multiplier", "residual_multiplier", "logits_scaling")


def float8_inputs(t):
    """``t``'s values rounded through ``torch.float8_e4m3fn``."""
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


class _Math:
    """The products, with ``rounded`` applied to each one's inputs."""

    def __init__(self, rounded):
        self.rounded = rounded

    def r(self, t):
        if self.rounded is None:
            return t
        return t + (self.rounded(t.detach()) - t).detach()

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(p, x, arch, cos, sin, m):
    s = x.shape[0]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    dh = arch["head_dim"]
    q = _rope(m.mm(x, p["wq"]["w"]).view(s, hq, dh), cos, sin)
    k = _rope(m.mm(x, p["wk"]["w"]).view(s, hkv, dh), cos, sin)
    v = m.mm(x, p["wv"]["w"]).view(s, hkv, dh)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scores = m.einsum("qhd,khd->hqk", q, k) * arch["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = m.einsum("hqk,khd->qhd", probs, v).reshape(s, hq * dh)
    return m.mm(out, p["wo"]["w"])


class _Routes:
    """Each layer's experts, by (sequence, layer): pinned ones read, the
    reference's own written; and the worst route gap seen."""

    def __init__(self, pinned, seq_len):
        self.pinned, self.seq_len = pinned, seq_len
        self.chosen, self.gap = {}, 0.0

    def choose(self, logits, top, at):
        b, layer = at
        if self.pinned is None:
            chosen = logits.topk(top, dim=-1).indices
        else:
            chosen = self.pinned[layer][b * self.seq_len:
                                        (b + 1) * self.seq_len]
            chosen = chosen.to(logits.device).long()
        self.chosen[at] = chosen
        z = logits.detach()
        inside = torch.zeros_like(z, dtype=torch.bool).scatter_(1, chosen,
                                                                True)
        low = z.masked_fill(~inside, float("inf")).amin(-1)
        high = z.masked_fill(inside, float("-inf")).amax(-1)
        spread = (z.amax(-1) - z.amin(-1)).clamp_min(1e-30)
        self.gap = max(self.gap, float(((high - low) / spread).max()), 0.0)
        return chosen


def _experts(p, x, arch, m, routes, at):
    top = arch["num_experts_per_tok"]
    logits = m.mm(x, p["router"]["w"])
    chosen = routes.choose(logits, top, at)
    gates = torch.softmax(logits.gather(1, chosen), -1)
    out = torch.zeros_like(x)
    for e in range(arch["num_local_experts"]):
        token, slot = (chosen == e).nonzero(as_tuple=True)
        if token.numel() == 0:
            continue
        xe = x[token]
        h = F.silu(m.mm(xe, p["w_gate"][e])) * m.mm(xe, p["w_up"][e])
        y = m.mm(h, p["w_down"][e]) * gates[token, slot, None]
        out = out.index_add(0, token, y)
    return out


def _layer(x, p, arch, cos, sin, m, routes, at):
    eps, res = arch["rms_norm_eps"], arch["residual_multiplier"]
    h = _attention(p["mixer"], _rmsnorm(x, p["norm1"]["scale"], eps), arch,
                   cos, sin, m)
    x = x + h * res
    h = _experts(p["ffn"], _rmsnorm(x, p["norm2"]["scale"], eps), arch, m,
                 routes, at)
    return x + h * res


def _sequence_logits(params, tokens, arch, m, routes, b):
    """Sequence ``b``'s logits (S, vocab)."""
    s = tokens.shape[0]
    dh = arch["head_dim"]
    half = dh // 2
    freqs = arch["rope_theta"] ** (
        -torch.arange(half, dtype=torch.float32, device=tokens.device) / half)
    ang = torch.arange(s, dtype=torch.float32,
                       device=tokens.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    table = params["embed"]["table"]
    x = table[tokens] * arch["embedding_multiplier"]
    for layer, p in enumerate(params["blocks"]):
        x = checkpoint(_layer, x, p, arch, cos, sin, m, routes, (b, layer),
                       use_reentrant=False)
    x = _rmsnorm(x, params["final_norm"]["scale"], arch["rms_norm_eps"])
    return m.mm(x, table.T) / arch["logits_scaling"]


def logits(params, tokens, arch):
    """The logits (B, S, vocab) of ``tokens`` (B, S), float32, TF32 off."""
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    routes = _Routes(None, tokens.shape[1])
    with _no_tf32(), torch.no_grad():
        return torch.stack([
            _sequence_logits(params, seq, arch, _Math(None), routes, b)
            for b, seq in enumerate(tokens)])


class _no_tf32:
    """Float32 products with TF32 off inside; the settings restored."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


class Step(NamedTuple):
    """What :func:`loss_and_grads` gives."""

    #: the mean next-token cross entropy
    loss: float
    #: its gradient, a tree of the parameters' form, float32
    grads: Any
    #: each layer's experts (B x S, top_k), the rows sequence by sequence
    routes: List[torch.Tensor]
    #: the worst, over layers and tokens, of how far the best logit of an
    #: expert left out lies above the least of one chosen, as a share of
    #: the token's logit range; 0 where every token's experts are the
    #: reference's top ``top_k``
    route_gap: float


def loss_and_grads(params, tokens, targets, arch, rounded=None,
                   routes=None):
    """The :class:`Step` of the mean next-token cross entropy over every
    token of ``tokens`` (B, S) against ``targets`` (B, S).

    ``params`` is a tree of dicts and lists of tensors (the program's
    names).  ``arch`` holds :data:`ARCH_KEYS`.  ``rounded`` (a function of
    a tensor) replaces the value of every product's inputs.  ``routes``
    (one (B x S, top_k) tensor a layer) pins each layer's experts; the
    route gap is then that of the pinned experts against the reference's
    own logits.  The products run in float32 with TF32 off."""
    leaves = [t.detach().float().requires_grad_(True)
              for t in _leaves(params)]
    tree = _rebuild(params, iter(leaves))
    tokens = torch.as_tensor(tokens, device=leaves[0].device).long()
    targets = torch.as_tensor(targets, device=leaves[0].device).long()
    count = tokens.numel()
    layers = len(params["blocks"])
    if routes is not None and (
            len(routes) != layers
            or any(tuple(r.shape) != (count, arch["num_experts_per_tok"])
                   for r in routes)):
        raise ValueError(
            f"routes: want {layers} of ({count}, "
            f"{arch['num_experts_per_tok']}), got "
            f"{[tuple(r.shape) for r in routes]}")
    m = _Math(rounded)
    chosen = _Routes(routes, tokens.shape[1])
    grads = [torch.zeros_like(t) for t in leaves]
    total = 0.0
    with _no_tf32(), torch.enable_grad():
        for b in range(tokens.shape[0]):
            loss = F.cross_entropy(
                _sequence_logits(tree, tokens[b], arch, m, chosen, b),
                targets[b], reduction="sum") / count
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, g in zip(grads, got):
                if g is not None:
                    acc += g
            total += float(loss.detach())
    used = [torch.cat([chosen.chosen[b, layer]
                       for b in range(tokens.shape[0])])
            for layer in range(layers)]
    return Step(total, _rebuild(params, iter(grads)), used, chosen.gap)


def _decayed(name, t):
    """Whether AdamW decays the leaf: a matrix, or a leaf of a layer (the
    published layout stacks the layers' leaves into one array each)."""
    return t.dim() >= 2 or name.startswith("blocks.")


def learning_rate(step, hp):
    """The learning rate of step ``step`` (counted from 0): linear warm-up
    over ``warmup_steps``, then a cosine decay to ``final_lr_frac`` of
    ``lr`` at ``total_steps``."""
    lr, warm = hp["lr"], hp["warmup_steps"]
    if step < warm:
        return lr * step / max(1, warm)
    prog = min(max((step - warm) / max(1, hp["total_steps"] - warm), 0.0),
               1.0)
    frac = hp["final_lr_frac"]
    return lr * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def clip_scale(grads, hp):
    """The factor clipping by the global norm puts on every gradient."""
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in _leaves(grads)))
    return min(1.0, hp["grad_clip"] / max(norm, 1e-9))


def adamw_leaf(name, p, g, m, v, step, hp, scale):
    """Leaf ``name``'s new value, float32, after AdamW step ``step``
    (counted from 0) from its value ``p``, gradient ``g`` (before
    clipping: times ``scale``) and moments ``m``, ``v``."""
    t = step + 1
    g = g.double() * scale
    m = hp["b1"] * m.double() + (1 - hp["b1"]) * g
    v = hp["b2"] * v.double() + (1 - hp["b2"]) * g * g
    delta = (m / (1 - hp["b1"] ** t)) / (
        torch.sqrt(v / (1 - hp["b2"] ** t)) + hp["eps"])
    if _decayed(name, p):
        delta = delta + hp["weight_decay"] * p.double()
    return (p.double() - learning_rate(step, hp) * delta).float()


def adamw_step(params, grads, m, v, step, hp):
    """The parameters after AdamW step ``step`` from ``params`` with
    gradients ``grads`` and moments ``m``, ``v`` (trees of one form);
    ``hp`` holds ``lr``, ``warmup_steps``, ``total_steps``,
    ``final_lr_frac``, ``b1``, ``b2``, ``eps``, ``weight_decay`` and
    ``grad_clip``."""
    scale = clip_scale(grads, hp)
    new = [adamw_leaf(n, *xs, step, hp, scale) for n, *xs in zip(
        leaf_names(params), _leaves(params), _leaves(grads), _leaves(m),
        _leaves(v))]
    return _rebuild(params, iter(new))


def rel_errors(grads, ref):
    """‖g − g_ref‖₂ / ‖g_ref‖₂ of each leaf, in float64, in the trees'
    leaf order (sorted keys, list order)."""
    out = []
    for g, r in zip(_leaves(grads), _leaves(ref)):
        r = r.double()
        gap = float(torch.linalg.vector_norm(g.double() - r))
        scale = float(torch.linalg.vector_norm(r))
        out.append(gap / scale if scale > 0 else gap)
    return out


def leaf_names(tree, prefix=""):
    """Each leaf's path (``blocks.3.ffn.router.w``), in leaf order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def arch_of(cfg):
    """:data:`ARCH_KEYS` of an object with the program's config fields
    (``d_model``, ``n_heads``, ... and ``scales``)."""
    s = cfg.scales
    return {"hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads or cfg.n_heads,
            "head_dim": cfg.d_head or cfg.d_model // cfg.n_heads,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "num_local_experts": cfg.moe.num_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "embedding_multiplier": 1.0 if s is None else s.embedding,
            "attention_multiplier": (
                1.0 / math.sqrt(cfg.d_head or cfg.d_model // cfg.n_heads)
                if s is None or s.attention is None else s.attention),
            "residual_multiplier": 1.0 if s is None else s.residual,
            "logits_scaling": 1.0 if s is None else s.logits}
