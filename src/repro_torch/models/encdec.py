"""Encoder-decoder model (seamless-m4t family).

The port of ``repro.models.encdec``.  The modality frontend is a stub, as
in the reference: the caller passes precomputed audio frame embeddings
(B, S_enc, d_model); the encoder is a bidirectional transformer over
frames, the decoder a causal transformer with cross-attention.  Decode
runs the decoder with a self-attention KV cache and cross-attention K/V
precomputed from the encoder memory.

JAX stacks the encoder's and the decoder's layers along a leading axis and
scans over them; here each stack is a Python list with one parameter dict
per layer, and the cache keeps one dict per decoder layer
(``self_k``/``self_v``/``cross_k``/``cross_v``).
:func:`repro_torch.convert.encdec_params_from_jax` maps the stacked JAX
layout onto it.  An :class:`EncDec` lives on one device, as an
:class:`~repro_torch.models.lm.LM` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..config import resolve_device
from . import attention as attn
from . import ffn as ffn_mod
from .decoder import checkpointed
from .layers import (dense, dense_init, embed_init, embedding_lookup,
                     rmsnorm, rmsnorm_init)

__all__ = ["EncDec"]


def _enc_layer_init(gen, cfg, dtype):
    dev = gen.device
    return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": attn.attn_init(gen, cfg, dtype),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
            "ffn": ffn_mod.ffn_init(gen, cfg, dtype)}


def _dec_layer_init(gen, cfg, dtype):
    dev = gen.device
    return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "self_attn": attn.attn_init(gen, cfg, dtype),
            "norm_x": rmsnorm_init(cfg.d_model, dtype, dev),
            "cross_attn": attn.attn_init(gen, cfg, dtype),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
            "ffn": ffn_mod.ffn_init(gen, cfg, dtype)}


@dataclasses.dataclass(frozen=True)
class EncDec:
    cfg: Any
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def n_enc(self) -> int:
        return self.cfg.n_encoder_layers

    @property
    def n_dec(self) -> int:
        return self.cfg.n_layers - self.cfg.n_encoder_layers

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def init(self, seed: int = 0, dtype=torch.float32) -> Dict[str, Any]:
        """Random params from ``seed`` on the model's device, stored as
        ``dtype``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {
            "frame_proj": dense_init(gen, cfg.d_model, cfg.d_model,
                                     dtype=dtype),
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "encoder": [_enc_layer_init(gen, cfg, dtype)
                        for _ in range(self.n_enc)],
            "decoder": [_dec_layer_init(gen, cfg, dtype)
                        for _ in range(self.n_dec)],
            "enc_norm": rmsnorm_init(cfg.d_model, dtype, self.device),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, self.device),
            "lm_head": dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype),
        }

    # -- encoder ------------------------------------------------------------
    def encode(self, params, frames, remat=True):
        """frames: (B, S_enc, d_model) -> the encoder memory.  With
        gradients on and ``remat`` truthy each layer is checkpointed, as
        JAX's scanned body is (any truthy ``remat`` saves nothing there)."""
        cfg = self.cfg
        x = dense(params["frame_proj"], self._tensor(frames))
        positions = torch.arange(x.shape[1], device=self.device)

        def body(xc, layer):
            xn = rmsnorm(layer["norm1"], xc, cfg.norm_eps)
            xc = xc + attn.attn_apply(layer["attn"], cfg, xn, positions,
                                      causal=False)
            xn = rmsnorm(layer["norm2"], xc, cfg.norm_eps)
            return xc + ffn_mod.ffn_apply(layer["ffn"], cfg, xn)

        for layer in params["encoder"]:
            x = checkpointed(body, bool(remat))(x, layer)
        return rmsnorm(params["enc_norm"], x, cfg.norm_eps)

    def _cross_kv(self, layer, memory):
        cfg = self.cfg
        b, s, _ = memory.shape
        hkv, dh = cfg.kv_heads, cfg.head_dim
        k = dense(layer["cross_attn"]["wk"], memory).reshape(b, s, hkv, dh)
        v = dense(layer["cross_attn"]["wv"], memory).reshape(b, s, hkv, dh)
        return k, v

    def _decoder_pass(self, params, x, positions, memory, remat=True):
        """The teacher-forced decoder over ``x`` (B, S, D), each layer
        checkpointed as :meth:`encode`'s."""
        cfg = self.cfg

        def body(xc, layer, memory):
            xn = rmsnorm(layer["norm1"], xc, cfg.norm_eps)
            xc = xc + attn.attn_apply(layer["self_attn"], cfg, xn, positions)
            xn = rmsnorm(layer["norm_x"], xc, cfg.norm_eps)
            xc = xc + attn.attn_apply(layer["cross_attn"], cfg, xn,
                                      positions,
                                      cross_kv=self._cross_kv(layer, memory))
            xn = rmsnorm(layer["norm2"], xc, cfg.norm_eps)
            return xc + ffn_mod.ffn_apply(layer["ffn"], cfg, xn)

        for layer in params["decoder"]:
            x = checkpointed(body, bool(remat))(x, layer, memory)
        return x

    # -- training -----------------------------------------------------------
    def loss(self, params, batch, remat=True):
        memory = self.encode(params, batch["frames"], remat)
        tokens = self._tensor(batch["tokens"]).long()
        x = embedding_lookup(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = self._decoder_pass(params, x, positions, memory, remat)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = dense(params["lm_head"], x).float()
        targets = self._tensor(batch["targets"]).long()
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        loss = (torch.logsumexp(logits, dim=-1) - gold).mean()
        return loss, {"loss": loss}

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        """One dict per decoder layer; the cross K/V lines are ``max_seq``
        long, as in JAX, and hold the memory from position 0."""
        cfg = self.cfg
        shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {
            "layers": [{"self_k": zeros(), "self_v": zeros(),
                        "cross_k": zeros(), "cross_v": zeros()}
                       for _ in range(self.n_dec)],
            "pos": torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),
        }

    def prefill(self, params, batch, cache):
        """Encode frames, write the cross K/V into the cache (in place) and
        prime the decoder with ``batch["tokens"]`` (B, 1), e.g. BOS."""
        memory = self.encode(params, batch["frames"])
        s_mem = memory.shape[1]
        for layer, c in zip(params["decoder"], cache["layers"]):
            k, v = self._cross_kv(layer, memory)
            c["cross_k"][:, :s_mem] = k.to(c["cross_k"].dtype)
            c["cross_v"][:, :s_mem] = v.to(c["cross_v"].dtype)
        cache = dict(cache)
        cache["mem_len"] = s_mem
        return self.decode_step(params, cache, batch["tokens"])

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) — one new token per sequence."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embedding_lookup(params["embed"], self._tensor(tokens).long())
        mem_len = cache.get("mem_len",
                            cache["layers"][0]["cross_k"].shape[1])
        for p, c in zip(params["decoder"], cache["layers"]):
            xn = rmsnorm(p["norm1"], x, cfg.norm_eps)
            h, _ = attn.attn_decode(p["self_attn"], cfg, xn, pos,
                                    attn.AttnCache(c["self_k"], c["self_v"]))
            x = x + h
            xn = rmsnorm(p["norm_x"], x, cfg.norm_eps)
            x = x + self._cross_decode(p["cross_attn"], xn, c["cross_k"],
                                       c["cross_v"], mem_len)
            xn = rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + ffn_mod.ffn_apply(p["ffn"], cfg, xn)
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return dense(params["lm_head"], x), new_cache

    def _cross_decode(self, p, x, k, v, mem_len):
        cfg = self.cfg
        b = x.shape[0]
        hq, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = dense(p["wq"], x).reshape(b, 1, hq, dh)
        n_rep = hq // hkv
        kk = attn._repeat_kv(k, n_rep)
        vv = attn._repeat_kv(v, n_rep)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
        scores = scores / math.sqrt(dh)
        valid = torch.arange(k.shape[1], device=x.device) < mem_len
        scores = torch.where(valid[None, None, None, :], scores,
                             torch.full_like(scores, attn.NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vv.dtype), vv)
        return dense(p["wo"], out.reshape(b, 1, hq * dh))
