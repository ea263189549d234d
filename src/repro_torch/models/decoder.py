"""Decoder blocks and the layer stack.

The port of ``repro.models.decoder`` for the ``attn``/``swa`` mixers with
``dense`` or ``moe`` FFNs.  JAX stacks each segment's parameters along a
leading layer axis and scans over it; here the stack is a Python list with
one parameter dict (and one cache dict) per layer, walked by a loop.
:func:`repro_torch.convert.lm_params_from_jax` maps the stacked JAX layout
onto it.

A block is (pre-norm mixer → residual → pre-norm ffn → residual).  The
``mamba`` and ``rwkv`` mixers are not ported yet (ROADMAP queue 1,
item 7) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import attention as attn
from . import ffn as ffn_mod
from . import moe as moe_mod
from .layers import dense, rmsnorm, rmsnorm_init

__all__ = ["stack_init", "stack_apply", "stack_cache", "stack_prefill",
           "stack_decode", "init_layer_cache"]

Signature = Tuple[str, str]     # (mixer, ffn)
_MIXERS = ("attn", "swa")


def _check_mixer(mixer: str) -> None:
    if mixer not in _MIXERS:
        raise NotImplementedError(
            f"mixer {mixer!r} is not ported yet (ROADMAP queue 1, item 7: "
            "mamba and rwkv); the port runs 'attn' and 'swa'")


def _signatures(cfg) -> List[Signature]:
    sigs = [cfg.layer_signature(i) for i in range(cfg.n_layers)]
    for mixer, _ in sigs:
        _check_mixer(mixer)
    return sigs


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg, sig: Signature,
                dtype=torch.float32):
    mixer, ffn = sig
    _check_mixer(mixer)
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dtype, gen.device),
                         "norm2": rmsnorm_init(cfg.d_model, dtype, gen.device),
                         "mixer": attn.attn_init(gen, cfg, dtype)}
    if ffn == "moe":
        p["ffn"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        p["ffn"] = ffn_mod.ffn_init(gen, cfg, dtype)
    return p


def _window(cfg, mixer: str) -> Optional[int]:
    return cfg.swa_window if mixer == "swa" else None


def _ffn(p, cfg, ffn: str, xn):
    if ffn == "moe":
        return moe_mod.moe_apply(p["ffn"], cfg, xn)
    return ffn_mod.ffn_apply(p["ffn"], cfg, xn)


def _block_apply(p, cfg, sig: Signature, x, positions):
    mixer, ffn = sig
    _check_mixer(mixer)
    xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attn.attn_apply(p["mixer"], cfg, xn, positions,
                            window=_window(cfg, mixer))
    xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p, cfg, ffn, xn)


def init_layer_cache(cfg, sig: Signature, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None
                     ) -> Dict[str, torch.Tensor]:
    """Zeroed per-layer cache for one signature."""
    mixer, _ = sig
    _check_mixer(mixer)
    size = min(max_seq, cfg.swa_window) if mixer == "swa" else max_seq
    c = attn.init_attn_cache(cfg, batch, size, dtype, device)
    return {"k": c.k, "v": c.v}


def _block_prefill(p, cfg, sig: Signature, x, positions, cache):
    """Prefill one block; the last ``cache_len`` tokens' K/V are written
    into ``cache`` in place, at slots ``pos % cache_len``."""
    mixer, ffn = sig
    _check_mixer(mixer)
    xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
    s = x.shape[1]
    cache_len = cache["k"].shape[1]
    q, k, v = attn._project_qkv(p["mixer"], cfg, xn, positions)
    h = attn.blockwise_attention(q, k, v, causal=True,
                                 window=_window(cfg, mixer))
    h = dense(p["mixer"]["wo"],
              h.reshape(x.shape[0], s, cfg.n_heads * cfg.head_dim))
    kk, vv = k[:, -cache_len:], v[:, -cache_len:]
    slots = positions[-kk.shape[1]:] % cache_len
    cache["k"][:, slots] = kk.to(cache["k"].dtype)
    cache["v"][:, slots] = vv.to(cache["v"].dtype)
    x = x + h
    xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p, cfg, ffn, xn), cache


def _block_decode(p, cfg, sig: Signature, x, pos, cache):
    mixer, ffn = sig
    _check_mixer(mixer)
    xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
    h, c = attn.attn_decode(p["mixer"], cfg, xn, pos,
                            attn.AttnCache(cache["k"], cache["v"]),
                            window=_window(cfg, mixer))
    x = x + h
    xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p, cfg, ffn, xn), {"k": c.k, "v": c.v}


# ---------------------------------------------------------------------------
# The stack: one parameter dict and one cache dict per layer
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg, dtype=torch.float32):
    """Per-layer params: a list with one block dict per layer."""
    return [_block_init(gen, cfg, sig, dtype) for sig in _signatures(cfg)]


def stack_apply(params, cfg, x, positions):
    for p, sig in zip(params, _signatures(cfg)):
        x = _block_apply(p, cfg, sig, x, positions)
    return x


def stack_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                device=None):
    """Cache list mirroring the per-layer params."""
    return [init_layer_cache(cfg, sig, batch, max_seq, dtype, device)
            for sig in _signatures(cfg)]


def stack_prefill(params, cfg, x, positions, caches):
    new_caches = []
    for p, sig, c in zip(params, _signatures(cfg), caches):
        x, c = _block_prefill(p, cfg, sig, x, positions, c)
        new_caches.append(c)
    return x, new_caches


def stack_decode(params, cfg, x, pos, caches):
    new_caches = []
    for p, sig, c in zip(params, _signatures(cfg), caches):
        x, c = _block_decode(p, cfg, sig, x, pos, c)
        new_caches.append(c)
    return x, new_caches
