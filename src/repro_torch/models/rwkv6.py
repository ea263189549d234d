"""RWKV-6 ("Finch") block: attention-free mixer with data-dependent decay.

The port of ``repro.models.rwkv6``, in plain PyTorch as the JAX module is
plain JAX (no TPU kernel lies here).  Time-mix recurrence per head (state
S ∈ R^{dh×dh}):

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    y_t = r_t (diag(u) k_tᵀ v_t + S_{t-1})

with the decay w_t produced per token by a LoRA on the shifted input.
Training and prefill run JAX's chunked linear recurrence with its
production chunk of 32: intra-chunk terms through a masked (L×L) product on
decay-normalized keys, the state carried across chunks by a Python loop in
place of ``lax.scan``.  The op order and the clamps (``1e-12`` on w, ``1e-24``
on the inclusive decay product, w padded with 1.0) are JAX's, so fp32
results agree to rounding.  Token-shift interpolation uses static
per-channel mixing, as in the reference.

Channel-mix is the standard squared-ReLU RWKV FFN.  ``repro.models
.scan_config`` (an XLA cost-probe switch) has no counterpart.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..sharding.act import merge_heads, shard, split_heads
from .layers import dense, dense_init, normal, rmsnorm, rmsnorm_init

__all__ = ["rwkv_init", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_time_decode", "rwkv_channel_decode", "RwkvCache",
           "init_rwkv_cache"]

#: sequence chunk of the wkv recurrence (JAX's production chunk)
CHUNK = 32


class RwkvCache(NamedTuple):
    state: torch.Tensor        # (B, H, dh, dh) wkv state
    shift_t: torch.Tensor      # (B, D) last input of time-mix
    shift_c: torch.Tensor      # (B, D) last input of channel-mix


def _heads(cfg):
    dh = cfg.rwkv_head_dim
    assert cfg.d_model % dh == 0, (cfg.d_model, dh)
    return cfg.d_model // dh, dh


def rwkv_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    h, dh = _heads(cfg)
    lora = 64
    dev = gen.device

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev).to(dtype)

    return {
        "mu": uniform((5, d)),                        # r,k,v,w,g shift mixes
        "wr": dense_init(gen, d, d, dtype=dtype),
        "wk": dense_init(gen, d, d, dtype=dtype),
        "wv": dense_init(gen, d, d, dtype=dtype),
        "wg": dense_init(gen, d, d, dtype=dtype),
        # base decay (per channel)
        "w0": torch.full((d,), math.log(0.3), dtype=dtype, device=dev),
        "w_lora_a": normal(gen, (d, lora), 0.01, dtype),
        "w_lora_b": normal(gen, (lora, d), 0.01, dtype),
        "u": normal(gen, (h, dh), 0.1, dtype),        # "bonus" first token
        "wo": dense_init(gen, d, d, dtype=dtype),
        "ln_x": rmsnorm_init(d, dtype, dev),
        # channel mix
        "mu_c": uniform((2, d)),
        "ck": dense_init(gen, d, cfg.d_ff, dtype=dtype),
        "cr": dense_init(gen, d, d, dtype=dtype),
        "cv": dense_init(gen, cfg.d_ff, d, dtype=dtype),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / carried state at t=0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    else:
        last = last[:, None, :].to(x.dtype)
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _time_projections(p, cfg, x, xs):
    h, _ = _heads(cfg)
    mu = p["mu"]
    r = split_heads(dense(p["wr"], _mix(x, xs, mu[0])), h)
    k = split_heads(dense(p["wk"], _mix(x, xs, mu[1])), h)
    v = split_heads(dense(p["wv"], _mix(x, xs, mu[2])), h)
    g = F.silu(dense(p["wg"], _mix(x, xs, mu[4])))
    # data-dependent decay (LoRA), w in (0, 1)
    xw = _mix(x, xs, mu[3]).float()
    lora = torch.tanh(xw @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    w = torch.exp(-torch.exp(p["w0"].float() + lora))
    w = split_heads(w, h)

    def sh(t):
        return shard(t, "dp", None, "model", None)

    return sh(r), sh(k), sh(v), shard(g, "dp", None, "model"), sh(w)


def _chunked_wkv(r, k, v, w, u, s0, *, chunk: int = CHUNK):
    """Chunked linear recurrence.  r/k/v/w: (B, S, H, dh) — w ∈ (0,1).

    Returns y: (B, S, H, dh) fp32 and the final state (B, H, dh, dh) fp32.
    """
    b, s, h, dh = r.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s

    def pad_to(x, value=0.0):
        x = x.float()
        return F.pad(x, (0, 0, 0, 0, 0, pad), value=value) if pad else x

    rf, kf, vf = pad_to(r), pad_to(k), pad_to(v)
    wf = pad_to(w, 1.0)
    uu = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    state = s0.float()
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        logw = torch.log(torch.clamp_min(wc, 1e-12))
        cum = torch.cumsum(logw, dim=1)           # inclusive prod_{u<=t}
        p_incl = torch.exp(cum)
        p_excl = torch.exp(cum - logw)            # prod_{u<t}
        q_hat = rc * p_excl
        k_hat = kc / torch.clamp_min(p_incl, 1e-24)
        # inter-chunk: state entering the chunk
        y_inter = torch.einsum("blhd,bhde->blhe", q_hat, state)
        # intra-chunk: strictly-causal pairs + bonus diagonal
        att = torch.einsum("blhd,bmhd->bhlm", q_hat, k_hat)
        att = torch.where(mask[None, None], att, torch.zeros_like(att))
        diag = torch.einsum("blhd,blhd->blh", rc * uu[None, None], kc)
        y_intra = torch.einsum("bhlm,bmhe->blhe", att, vc) \
            + diag[..., None] * vc
        # state update: decay over the whole chunk + discounted outer sums
        p_tot = p_incl[:, -1]                     # (B, H, dh)
        k_contrib = k_hat * p_tot[:, None]
        state = state * p_tot[..., None] \
            + torch.einsum("blhd,blhe->bhde", k_contrib, vc)
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state


def rwkv_time_mix(p, cfg, x, *, state=None, last=None):
    """x: (B, S, D) -> (B, S, D), the final state and the last token's
    input (for the cache)."""
    b, s, d = x.shape
    h, dh = _heads(cfg)
    xs = _shift(x, last)
    r, k, v, g, w = _time_projections(p, cfg, x, xs)
    s0 = state if state is not None else torch.zeros(
        (b, h, dh, dh), dtype=torch.float32, device=x.device)
    y, s_fin = _chunked_wkv(r, k, v, w, p["u"], s0)
    y = rmsnorm(p["ln_x"], merge_heads(y), cfg.norm_eps)
    out = dense(p["wo"], y.to(x.dtype) * g)
    return out, s_fin, x[:, -1]


def rwkv_channel_mix(p, cfg, x, *, last=None):
    xs = _shift(x, last)
    mu = p["mu_c"]
    kx = _mix(x, xs, mu[0])
    rx = _mix(x, xs, mu[1])
    k = torch.square(F.relu(dense(p["ck"], kx)))
    r = torch.sigmoid(dense(p["cr"], rx))
    return r * dense(p["cv"], k), x[:, -1]


def init_rwkv_cache(cfg, batch: int, dtype=torch.float32,
                    device=None) -> RwkvCache:
    h, dh = _heads(cfg)
    return RwkvCache(
        state=torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
        shift_t=torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),
        shift_c=torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),
    )


def rwkv_time_decode(p, cfg, x, cache: RwkvCache
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token time-mix.  x: (B, 1, D)."""
    b = x.shape[0]
    xs = cache.shift_t[:, None, :].to(x.dtype)
    r, k, v, g, w = _time_projections(p, cfg, x, xs)
    r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
    s_prev = cache.state.float()
    kv = torch.einsum("bhd,bhe->bhde", k1, v1)
    wkv = s_prev + p["u"].float()[None, :, :, None] * kv
    y = torch.einsum("bhd,bhde->bhe", r1, wkv).reshape(b, 1, -1)
    state = s_prev * w1[..., None] + kv
    y = rmsnorm(p["ln_x"], y, cfg.norm_eps)
    out = dense(p["wo"], y.to(x.dtype) * g)
    return out, state, x[:, -1]


def rwkv_channel_decode(p, cfg, x, cache: RwkvCache):
    return rwkv_channel_mix(p, cfg, x, last=cache.shift_c)
