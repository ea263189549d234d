"""Decoder blocks and the layer stack.

The port of ``repro.models.decoder``: the ``attn``/``swa`` mixers with
``dense`` or ``moe`` FFNs, the ``mamba`` mixer (jamba's hybrid periods)
and the ``rwkv`` block.  JAX stacks each segment's parameters along a
leading layer axis and scans over it; here the stack is a Python list with
one parameter dict (and one cache dict) per layer, walked by a loop.
:func:`repro_torch.convert.lm_params_from_jax` maps the stacked JAX layout
onto it.

A block is (pre-norm mixer → residual → pre-norm ffn → residual); the rwkv
block replaces attention/FFN with time-mix/channel-mix.  With gradients
on, :func:`stack_apply` checkpoints each period of the stack, as JAX's
``jax.checkpoint`` wraps its scanned body (:func:`checkpointed`).  Prefill and
decode write each layer's new state into its cache tensors in place.  The
recurrent states (mamba's ``conv``/``ssm``, rwkv's ``state``/``shift_*``)
are fp32 whatever the cache's ``dtype``, as JAX's ``init_layer_cache``
makes them.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import ffn as ffn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from .layers import dense, rmsnorm, rmsnorm_init

__all__ = ["stack_init", "stack_apply", "stack_cache", "stack_prefill",
           "stack_decode", "init_layer_cache", "checkpointed"]

Signature = Tuple[str, str]     # (mixer, ffn)


def _signatures(cfg) -> List[Signature]:
    return [cfg.layer_signature(i) for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg, sig: Signature,
                dtype=torch.float32):
    mixer, ffn = sig
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dtype, gen.device),
                         "norm2": rmsnorm_init(cfg.d_model, dtype, gen.device)}
    if mixer in ("attn", "swa"):
        p["mixer"] = attn.attn_init(gen, cfg, dtype)
    elif mixer == "mamba":
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, dtype)
    elif mixer == "rwkv":
        p["mixer"] = rwkv_mod.rwkv_init(gen, cfg, dtype)
    else:
        raise ValueError(mixer)
    if mixer != "rwkv":   # rwkv's channel-mix lives inside its params
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


def _write(cache, **new):
    """Copy each new state into its cache tensor (cast to its dtype)."""
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


def _block_apply(p, cfg, sig: Signature, x, positions):
    mixer, ffn = sig
    if mixer == "rwkv":
        h, _, _ = rwkv_mod.rwkv_time_mix(
            p["mixer"], cfg, rmsnorm(p["norm1"], x, cfg.norm_eps))
        x = x + h
        h, _ = rwkv_mod.rwkv_channel_mix(
            p["mixer"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps))
        return x + h
    xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer in ("attn", "swa"):
        h = attn.attn_apply(p["mixer"], cfg, xn, positions,
                            window=_window(cfg, mixer))
    elif mixer == "mamba":
        h = mamba_mod.mamba_apply(p["mixer"], cfg, xn)
    else:
        raise ValueError(mixer)
    x = x + h
    xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p, cfg, ffn, xn)


def init_layer_cache(cfg, sig: Signature, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None
                     ) -> Dict[str, torch.Tensor]:
    """Zeroed per-layer cache for one signature.  ``dtype`` is the K/V
    dtype; recurrent states are fp32."""
    mixer, _ = sig
    if mixer in ("attn", "swa"):
        size = min(max_seq, cfg.swa_window) if mixer == "swa" else max_seq
        c = attn.init_attn_cache(cfg, batch, size, dtype, device)
        return {"k": c.k, "v": c.v}
    if mixer == "mamba":
        c = mamba_mod.init_mamba_cache(cfg, batch, device=device)
        return {"conv": c.conv, "ssm": c.ssm}
    if mixer == "rwkv":
        c = rwkv_mod.init_rwkv_cache(cfg, batch, device=device)
        return {"state": c.state, "shift_t": c.shift_t, "shift_c": c.shift_c}
    raise ValueError(mixer)


def _block_prefill(p, cfg, sig: Signature, x, positions, cache):
    """Prefill one block and write its state into ``cache`` in place: an
    attention layer's last ``cache_len`` tokens' K/V at slots
    ``pos % cache_len``, a recurrent layer's terminal state."""
    mixer, ffn = sig
    if mixer == "rwkv":
        xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
        h, state, last_t = rwkv_mod.rwkv_time_mix(p["mixer"], cfg, xn)
        x = x + h
        xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
        h, last_c = rwkv_mod.rwkv_channel_mix(p["mixer"], cfg, xn)
        return x + h, _write(cache, state=state, shift_t=last_t,
                             shift_c=last_c)
    xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer in ("attn", "swa"):
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
    elif mixer == "mamba":
        # the terminal state comes from the same scan as the output; JAX
        # runs the scan again for it (_mamba_terminal_state), which gives
        # the same values
        h, conv, ssm = mamba_mod._mamba_forward(p["mixer"], cfg, xn)
        _write(cache, conv=conv, ssm=ssm)
    else:
        raise ValueError(mixer)
    x = x + h
    xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p, cfg, ffn, xn), cache


def _block_decode(p, cfg, sig: Signature, x, pos, cache):
    mixer, ffn = sig
    if mixer == "rwkv":
        c = rwkv_mod.RwkvCache(cache["state"], cache["shift_t"],
                               cache["shift_c"])
        xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
        h, state, last_t = rwkv_mod.rwkv_time_decode(p["mixer"], cfg, xn, c)
        x = x + h
        xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
        h, last_c = rwkv_mod.rwkv_channel_decode(p["mixer"], cfg, xn, c)
        return x + h, _write(cache, state=state, shift_t=last_t,
                             shift_c=last_c)
    xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer in ("attn", "swa"):
        h, c = attn.attn_decode(p["mixer"], cfg, xn, pos,
                                attn.AttnCache(cache["k"], cache["v"]),
                                window=_window(cfg, mixer))
        cache = {"k": c.k, "v": c.v}
    elif mixer == "mamba":
        h, c = mamba_mod.mamba_decode(
            p["mixer"], cfg, xn,
            mamba_mod.MambaCache(cache["conv"], cache["ssm"]))
        # JAX's cache takes the conv state in the activations' dtype; the
        # fp32 cache holds the same bf16-rounded values
        _write(cache, conv=c.conv, ssm=c.ssm)
    else:
        raise ValueError(mixer)
    x = x + h
    xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _ffn(p, cfg, ffn, xn), cache


# ---------------------------------------------------------------------------
# The stack: one parameter dict and one cache dict per layer
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg, dtype=torch.float32):
    """Per-layer params: a list with one block dict per layer."""
    return [_block_init(gen, cfg, sig, dtype) for sig in _signatures(cfg)]


#: the products ``remat="dots"`` keeps for the backward (JAX's
#: ``dots_with_no_batch_dims_saveable``, here with the batched family too);
#: everything else, K3's outputs included, is recomputed
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default]


def checkpointed(fn: Callable, remat) -> Callable:
    """``fn`` under activation checkpointing by JAX's ``remat`` knob:
    ``True``/``"nothing"`` saves only ``fn``'s inputs and recomputes the
    rest in the backward, ``"dots"`` also keeps the matmul outputs
    (selective checkpointing), ``False``/``None`` is ``fn`` itself.  With
    gradients off there is nothing to save, and ``fn`` runs as it is."""
    if remat is False or remat is None or not torch.is_grad_enabled():
        return fn
    kw: Dict[str, Any] = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    elif remat not in (True, "nothing"):
        raise ValueError(f"remat: want False, True, 'nothing' or 'dots', "
                         f"got {remat!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def stack_apply(params, cfg, x, positions, remat=True):
    """The stack over ``x``; each period of each segment (one layer, or
    jamba's 8) is one body checkpointed under ``remat``
    (:func:`checkpointed`)."""
    i = 0
    for period, count in cfg.segments():
        for _ in range(count):
            layers = params[i:i + len(period)]

            def body(xc, layers=layers, period=period):
                for p, sig in zip(layers, period):
                    xc = _block_apply(p, cfg, sig, xc, positions)
                return xc

            x = checkpointed(body, remat)(x)
            i += len(period)
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
