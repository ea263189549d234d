"""Unified language-model API: init / logits / loss / prefill / decode.

The port of ``repro.models.lm``: decoder-only archs (dense, MoE, hybrid
Mamba/attention, RWKV, early-fusion VLM — all token-frontend), and
``build_model`` hands the encoder-decoder (``kind="encdec"``) to
:class:`repro_torch.models.encdec.EncDec`, as JAX's does.

A model lives on one device: ``build_model(cfg)`` puts it on the card,
``build_model(cfg, device="cpu")`` on the CPU.  Token inputs may be numpy
arrays or tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..config import resolve_device
from . import decoder
from .layers import (dense, dense_init, embed_init, embedding_lookup,
                     rmsnorm, rmsnorm_init)

__all__ = ["build_model", "LM"]


def _cross_entropy(logits, targets, mask=None):
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, targets[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: Any
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0, dtype=torch.float32) -> Dict[str, Any]:
        """Random params from ``seed`` on the model's device, stored as
        ``dtype`` (fp32 as in JAX, or bf16 for serving)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        p = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "blocks": decoder.stack_init(gen, cfg, dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, self.device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                      dtype=dtype)
        return p

    # -- forward -----------------------------------------------------------
    def _logits_from_h(self, params, h):
        h = rmsnorm(params["final_norm"], h, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return torch.matmul(h, params["embed"]["table"].to(h.dtype).T)
        return dense(params["lm_head"], h)

    def logits(self, params, tokens, remat=True):
        """``remat`` (JAX's knob: True/"nothing", "dots" or False) applies
        only with gradients on; see :func:`decoder.checkpointed`."""
        tokens = self._tokens(tokens)
        x = embedding_lookup(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = decoder.stack_apply(params["blocks"], self.cfg, x, positions,
                                remat)
        return self._logits_from_h(params, x)

    def loss(self, params, batch, remat=True):
        logits = self.logits(params, batch["tokens"], remat)
        loss = _cross_entropy(logits, self._tokens(batch["targets"]),
                              batch.get("mask"))
        return loss, {"loss": loss}

    # -- serving -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        return {"layers": decoder.stack_cache(self.cfg, batch, max_seq,
                                              dtype, self.device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    def prefill(self, params, tokens, cache):
        """Prefill ``tokens`` (B, S) into ``cache`` (its tensors are written
        in place); returns the last position's logits and the cache."""
        tokens = self._tokens(tokens)
        x = embedding_lookup(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        x, layers = decoder.stack_prefill(params["blocks"], self.cfg, x,
                                          positions, cache["layers"])
        logits = self._logits_from_h(params, x[:, -1:])
        pos = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=self.device)
        return logits, {"layers": layers, "pos": pos}

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) — one new token per sequence."""
        pos = cache["pos"]
        x = embedding_lookup(params["embed"], self._tokens(tokens))
        x, layers = decoder.stack_decode(params["blocks"], self.cfg, x, pos,
                                         cache["layers"])
        logits = self._logits_from_h(params, x)
        return logits, {"layers": layers, "pos": pos + 1}


def build_model(cfg, device=None):
    """The model for ``cfg`` on ``device`` (``None``: the card): an
    :class:`~repro_torch.models.encdec.EncDec` for ``kind="encdec"``, else
    an :class:`LM`."""
    if cfg.kind == "encdec":
        from .encdec import EncDec
        return EncDec(cfg, device)
    return LM(cfg, device)

