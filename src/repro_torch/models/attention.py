"""Attention: GQA/MQA with RoPE, optional QK-norm / QKV bias / sliding window,
blockwise (flash-style) prefill attention, and KV-cache decode.

The port of ``repro.models.attention``.  The JAX module is plain JAX (no
TPU kernel lies here); its blockwise attention has two routes here, chosen
by :func:`repro_torch.kernels.attention.route` from the inputs alone:

- bf16 on the card: the fused kernel of ``csrc/attention.cu``, forward and
  backward (:func:`repro_torch.kernels.attention.fused_attention`);
- on the CPU (and meta tensors), and fp32/fp64 inputs anywhere: the plain
  loop, as JAX's.  Queries and keys are processed in blocks with a running
  (max, denominator) softmax in fp32; Python loops take the place of
  ``lax.map``/``lax.scan``.  Score and value products take bf16 inputs
  widened to fp32, as JAX's ``preferred_element_type=float32`` (fp64
  inputs stay fp64, for the gradient checks).

The softmax takes the scores times 1/sqrt(head_dim), or times a config's
``scales.attention`` where it has scales (:func:`softmax_scale`).

Decode and prefill write K/V into the cache tensors in place and return
them: the serving engine replaces its cache with the returned one, as it
does in JAX, and keeps no copy of the old one.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import attention as kattn
from ..sharding.act import is_dtensor, merge_heads, shard, split_heads
from .layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init, rope

__all__ = ["attn_init", "attn_apply", "attn_decode", "AttnCache",
           "init_attn_cache", "blockwise_attention", "softmax_scale",
           "write_rows", "write_slot"]

NEG_INF = -1e30
#: :func:`blockwise_attention`'s query rows a block
BLOCK_Q = 512


class AttnCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hkv, Dh)
    v: torch.Tensor          # (B, S_max, Hkv, Dh)


def attn_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, hq * dh, bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, hq * dh, d, dtype=dtype),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(dh, dtype, gen.device)
        p["knorm"] = rmsnorm_init(dh, dtype, gen.device)
    return p


def softmax_scale(cfg) -> Optional[float]:
    """The config's attention scale (``scales.attention``), or None for
    1/sqrt(head_dim)."""
    return None if cfg.scales is None else cfg.scales.attention


def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = shard(split_heads(dense(p["wq"], x), hq), "dp", None, "model", None)
    k = shard(split_heads(dense(p["wk"], x), hkv), "dp", None, "model", None)
    v = shard(split_heads(dense(p["wv"], x), hkv), "dp", None, "model", None)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(p["knorm"], k, cfg.norm_eps)
    cos, sin = rope(positions, dh, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv * n_rep, Dh), each kv head repeated
    ``n_rep`` times in place (``jnp.repeat`` along the head axis)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        block_q: int = BLOCK_Q, block_k: int = 1024,
                        gqa_native: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style attention.

    q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh) with Hq a multiple of Hkv.
    ``gqa_native=False`` repeats K/V to Hq heads, ``True`` groups query heads
    against their kv head; ``q_offset`` positions the queries in the key
    timeline; ``window`` enables sliding-window attention; ``scale``
    multiplies the scores (None: 1/sqrt(Dh)).

    bf16 inputs on the card run the fused kernel
    (:func:`repro_torch.kernels.attention.fused_attention`; query head h
    reads kv head h // (Hq / Hkv) whatever ``gqa_native``, and the blocks
    are the kernel's own), or raise where it cannot take them
    (:func:`repro_torch.kernels.attention.route`).  Everything else runs
    the plain loop below; ``blockwise_attention.plain_cuda_calls`` counts
    its calls on CUDA tensors.

    ``block_q`` and ``block_k`` set the plain loop's query rows and keys of
    a block.
    """
    if kattn.route(q.device.type, (q.dtype, k.dtype, v.dtype), q.shape,
                   k.shape) == "kernel":
        return kattn.fused_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if q.device.type == "cuda":
        blockwise_attention.plain_cuda_calls += 1
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    if not gqa_native and h != hkv:
        k = _repeat_kv(k, h // hkv)
        v = _repeat_kv(v, h // hkv)
        hkv = h
    n_rep = h // hkv
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    dev = q.device
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    nq = -(-sq // block_q)
    nk = -(-sk // block_k)
    acc_t = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(acc_t).reshape(b, sq, hkv, n_rep, dh)
    kf, vf = k.to(acc_t), v.to(acc_t)
    k_pos_all = torch.arange(sk, device=dev)
    outs = []
    for qi in range(nq):
        qb = qf[:, qi * block_q:(qi + 1) * block_q]
        bq = qb.shape[1]
        q_pos = q_offset + qi * block_q + torch.arange(bq, device=dev)
        m = torch.full((b, hkv, n_rep, bq), NEG_INF, dtype=acc_t,
                       device=dev)
        l = torch.zeros((b, hkv, n_rep, bq), dtype=acc_t, device=dev)
        acc = torch.zeros((b, hkv, n_rep, bq, dh), dtype=acc_t, device=dev)
        for ki in range(nk):
            kb = kf[:, ki * block_k:(ki + 1) * block_k]
            vb = vf[:, ki * block_k:(ki + 1) * block_k]
            kp = k_pos_all[ki * block_k:(ki + 1) * block_k]
            # grouped scores: kv head h serves its n_rep query heads (r)
            s = torch.einsum("bqhrd,bkhd->bhrqk", qb, kb) * scale
            mask = torch.ones((bq, kp.shape[0]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (q_pos[:, None] >= kp[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - window < kp[None, :])
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhrqk,bkhd->bhrqd", p, vb)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        # (B, hkv, r, bq, dh) -> (B, bq, hkv, r, dh)
        outs.append(out.permute(0, 3, 1, 2, 4))
    out = torch.cat(outs, dim=1).reshape(b, sq, h, dh)
    return out.to(v.dtype)


blockwise_attention.plain_cuda_calls = 0


def _repeat_heads(t, heads: int):
    """(B, S, Hkv, Dh) -> (B, S, heads, Dh), each kv head repeated in
    place, as :func:`_repeat_kv`, in view ops that DTensor shards."""
    b, s, hkv, dh = t.shape
    if hkv == heads:
        return t
    n_rep = heads // hkv
    return t[:, :, :, None, :].expand(b, s, hkv, n_rep, dh).reshape(
        b, s, heads, dh)


def _attend(q, k, v, **kw):
    """:func:`blockwise_attention`; on DTensors, per shard of batch and
    heads.

    Heads and sequences are independent, so each rank attends its own
    slice with plain tensors (``local_map``): Q, K and V placed alike,
    batch on the data axes and heads on "model" where they were split,
    every other mesh dim gathered.  A rank's slice of query heads then
    reads its own slice of kv heads (h // n_rep), as the unsharded call
    does, so both sum each kv head's gradient the same way; only where
    the head shards do not divide both head counts are K/V repeated to
    the query heads first."""
    if not is_dtensor(q):
        return blockwise_attention(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    placements = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                       else Replicate() for p in q.placements)
    h, hkv = q.shape[2], k.shape[2]
    split = math.prod(mesh.size(i) for i, p in enumerate(placements)
                      if isinstance(p, Shard) and p.dim == 2)
    if h % split or hkv % split:
        k, v = _repeat_heads(k, h), _repeat_heads(v, h)
    q, k, v = (t.redistribute(mesh, placements) for t in (q, k, v))
    fn = local_map(functools.partial(blockwise_attention, **kw),
                   out_placements=(placements,),
                   in_placements=(placements,) * 3, device_mesh=mesh)
    return fn(q, k, v)


def attn_apply(p, cfg, x, positions, *, window: Optional[int] = None,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               causal: bool = True) -> torch.Tensor:
    """Prefill/training attention.  x: (B, S, D).

    ``cross_kv=(k, v)`` (each (B, S_mem, Hkv, Dh)) makes it
    cross-attention: queries get no RoPE (qk-norm still applies), keys and
    values come from the memory, and no causal mask is applied.
    """
    b, s, _ = x.shape
    hq, dh = cfg.n_heads, cfg.head_dim
    if cross_kv is not None:
        q = dense(p["wq"], x).reshape(b, s, hq, dh)
        if cfg.qk_norm:
            q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k, v = cross_kv
        causal = False
    else:
        q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(q, k, v, causal=causal, window=window,
                  scale=softmax_scale(cfg))
    return dense(p["wo"], merge_heads(out))


def init_attn_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                    device=None) -> AttnCache:
    hkv, dh = cfg.kv_heads, cfg.head_dim
    return AttnCache(
        k=torch.zeros((batch, max_seq, hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, max_seq, hkv, dh), dtype=dtype, device=device),
    )


def _replicated(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (made on every rank
    alike, as positions are) counts as replicated."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def write_slot(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor
               ) -> torch.Tensor:
    """``buf[b, slot[b]] = new[b]`` for every sequence b, in place, and
    return ``buf``.  buf: (B, S, ...); slot: (B,); new: (B, ...).

    On a DTensor cache each rank writes its own shard (``local_map``),
    ``new`` and ``slot`` placed as the cache's batch and inner dims.  A
    cache sharded along S (sequence-parallel KV) is rewritten out of place
    instead: a rank cannot tell from its shard alone whether it holds the
    slot; the new cache is returned."""
    new = new.to(buf.dtype)
    if not is_dtensor(buf):
        buf[torch.arange(buf.shape[0], device=buf.device), slot] = new
        return buf
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = buf.device_mesh
    if any(isinstance(p, Shard) and p.dim == 1 for p in buf.placements):
        hit = torch.arange(buf.shape[1], device=slot.device) == slot[:, None]
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        return torch.where(hit, new[:, None], buf)
    new_pl = tuple(Shard(p.dim - (p.dim > 0)) if isinstance(p, Shard)
                   else Replicate() for p in buf.placements)
    slot_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                    else Replicate() for p in buf.placements)
    new, slot = (_replicated(t, mesh).redistribute(mesh, pl)
                 for t, pl in ((new, new_pl), (slot, slot_pl)))

    def write(b_local, slot_local, new_local):
        b_local[torch.arange(b_local.shape[0], device=b_local.device),
                slot_local] = new_local
        return b_local

    fn = local_map(write, out_placements=(tuple(buf.placements),),
                   in_placements=(tuple(buf.placements), slot_pl, new_pl),
                   device_mesh=mesh)
    return fn(buf, slot, new)


def write_rows(buf: torch.Tensor, slots: torch.Tensor, new: torch.Tensor
               ) -> torch.Tensor:
    """``buf[:, slots] = new`` in place, and return ``buf``.  buf: (B, S,
    ...); slots: (S_new,) plain; new: (B, S_new, ...).

    On a DTensor cache each rank writes its own shard (``local_map``),
    ``new`` placed as the cache; a cache sharded along S is rewritten out
    of place (``index_copy``) and the new one returned."""
    new = new.to(buf.dtype)
    if not is_dtensor(buf):
        buf[:, slots] = new
        return buf
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if any(isinstance(p, Shard) and p.dim == 1 for p in buf.placements):
        return buf.index_copy(1, slots, new)
    pl = tuple(buf.placements)

    def write(b_local, new_local, slots_local):
        b_local[:, slots_local] = new_local
        return b_local

    fn = local_map(write, out_placements=(pl,),
                   in_placements=(pl, pl, (Replicate(),) * len(pl)),
                   device_mesh=buf.device_mesh, redistribute_inputs=True)
    return fn(buf, new, slots)


def _placed_as_cache(q, k_cache):
    """On DTensors, the decode queries (B, 1, Hq, Dh) sharded as the cache
    (B, S, Hkv, Dh) is along batch, heads and Dh, so the grouped scores
    run on each rank's shard (a Dh shard sums over the ranks).  A head
    shard of the cache covers whole groups of query heads."""
    if not (is_dtensor(q) and is_dtensor(k_cache)):
        return q
    from torch.distributed.tensor import Replicate, Shard

    return q.redistribute(q.device_mesh, tuple(
        p if isinstance(p, Shard) and p.dim != 1 else Replicate()
        for p in k_cache.placements))


def attn_decode(p, cfg, x, pos, cache: AttnCache, *,
                window: Optional[int] = None):
    """Single-token decode.  x: (B, 1, D); pos: (B,) per-sequence index
    (per-slot positions enable continuous batching in the serve engine).

    With sliding-window attention the cache is a ring buffer of size
    ``window``; otherwise it covers the full context.  The new K/V are
    written into ``cache`` in place.
    """
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    pos = pos.expand(b) if pos.dim() == 0 else pos
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])

    s_max = cache.k.shape[1]
    slot = pos % s_max if window is not None else pos
    cache = AttnCache(write_slot(cache.k, slot, k[:, 0]),
                      write_slot(cache.v, slot, v[:, 0]))

    # GQA-native decode: scores grouped by kv head, the cache never repeated
    n_rep = hq // hkv
    q = _placed_as_cache(q, cache.k)
    qg = q.reshape(b, 1, hkv, n_rep, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                          cache.k.float())
    scale = softmax_scale(cfg)
    scores = scores / math.sqrt(dh) if scale is None else scores * scale
    idx = torch.arange(s_max, device=x.device)
    pos_b = pos[:, None, None, None, None]
    if window is not None:
        valid = idx < torch.clamp_max(pos_b + 1, s_max)
    else:
        valid = idx <= pos_b
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(cache.v.dtype), cache.v)
    if is_dtensor(out):
        # keep batch and kv-head shards, gather the rest before the flatten
        from torch.distributed.tensor import Replicate, Shard

        out = out.redistribute(out.device_mesh, tuple(
            p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in out.placements))
    return dense(p["wo"], out.reshape(b, 1, hq * dh)), cache
