"""The rest of the port's model zoo against the JAX package: the mamba and
rwkv6 mixers, cross-attention, and the dense, MoE and VLM decoders of the
seven configs added beside the first three.

Same numpy-seeded inputs and the same parameters (JAX's, carried over with
``repro_torch.convert``) through both packages, on the CPU.  Tolerances,
each relative to the reference's largest magnitude unless a test says
otherwise:

- fp32 pieces (conv, scans, wkv, the mixers and their decodes): 1e-5.
  Both ``dense`` functions compute in bf16 by default; the ``fp32``
  fixture switches both packages' ``dense`` and ``embedding_lookup`` to
  fp32 for a test, so the whole computation is fp32 on both sides.
- whole models in fp32 (the same fixture): 1e-4 of the largest logit.
- whole models as served, in bf16: 3e-2 of the largest logit, as
  ``tests/test_torch_models.py`` holds granite.  Both packages round the
  same products to bf16, but XLA on the CPU fuses elementwise chains and
  may keep them in fp32 where torch rounds after each op (``silu`` alone
  lands a bf16 ulp apart), so values an ulp apart propagate through the
  layers.  rwkv6 is held to 6e-2: each of its blocks runs seven bf16
  token-shift mixes and gates before its products (3.8e-2 on these
  inputs, while the same model in fp32 passes ``test_decoder_fp32``'s
  1e-4).

jamba's whole-model tests live in ``test_torch_jamba.py`` (one module
fixture holds its JAX smoke model), the encoder-decoder's in
``test_torch_encdec.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import EncDec, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv6 as trwkv


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree(tree):
    return jax.tree.map(_t, tree)


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' ``dense`` and ``embedding_lookup`` compute in fp32
    for the test.  Only for eager calls: nothing here is jitted, so no
    trace outlives the test."""
    for fn in (jlayers.dense, jlayers.embedding_lookup):
        monkeypatch.setattr(fn, "__defaults__", (jnp.float32,))
    for fn in (tlayers.dense, tlayers.embedding_lookup):
        monkeypatch.setattr(fn, "__defaults__", (torch.float32,))


def test_registry_matches_the_reference():
    assert ARCH_IDS == JAX_ARCH_IDS


# -- mamba -------------------------------------------------------------------


JAMBA = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def mamba_params():
    cfg = jax_get_config(JAMBA, smoke=True)
    jp = jmamba.mamba_init(jax.random.PRNGKey(0), cfg)
    return cfg, get_config(JAMBA, smoke=True), jp, _tree(jp)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(mamba_params, with_state):
    """fp32; 1e-6 (the same products summed in the same order)."""
    cfg, _, jp, tp = mamba_params
    rng = np.random.default_rng(0)
    d_inner = cfg.mamba_expand * cfg.d_model
    x = rng.standard_normal((2, 9, d_inner)).astype(np.float32)
    w = rng.standard_normal((4, d_inner)).astype(np.float32)
    b = rng.standard_normal(d_inner).astype(np.float32)
    st = rng.standard_normal((2, 3, d_inner)).astype(np.float32) \
        if with_state else None
    want, want_st = jmamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = tmamba._causal_conv(_t(x), _t(w), _t(b),
                                      None if st is None else _t(st))
    assert _rel(got, want) < 1e-6 and _rel(got_st, want_st) < 1e-6


@pytest.mark.parametrize("chunk", [256, 32, 16])
def test_selective_scan(mamba_params, chunk):
    """S = 70 (not a multiple of 32 or 16; one short chunk of 256) from a
    nonzero state: the port's doubling scan against JAX's
    ``associative_scan``, fp32, 1e-5 for y and the final state."""
    cfg, tcfg, jp, tp = mamba_params
    rng = np.random.default_rng(1)
    d_inner = cfg.mamba_expand * cfg.d_model
    xc = rng.standard_normal((2, 70, d_inner)).astype(np.float32)
    h0 = 0.5 * rng.standard_normal((2, d_inner, cfg.mamba_d_state)
                                   ).astype(np.float32)
    wy, wh = jmamba._selective_scan_chunked(jp, cfg, jnp.asarray(xc),
                                            chunk=chunk, h0=jnp.asarray(h0))
    gy, gh = tmamba._selective_scan_chunked(tp, tcfg, _t(xc), chunk=chunk,
                                            h0=_t(h0))
    assert gy.dtype == gh.dtype == torch.float32
    assert _rel(gy, wy) < 1e-5 and _rel(gh, wh) < 1e-5


def test_scan_chunk_doubling_matches_a_loop():
    """The doubling scan equals the plain recurrence h_t = a_t h_{t-1} +
    b_t, at lengths that are and are not powers of two (fp32, 1e-6)."""
    rng = np.random.default_rng(2)
    for length in (1, 5, 8, 13):
        a = _t(rng.uniform(0.2, 1.0, (2, length, 3, 4)).astype(np.float32))
        b = _t(rng.standard_normal((2, length, 3, 4)).astype(np.float32))
        h0 = _t(rng.standard_normal((2, 3, 4)).astype(np.float32))
        hs, last = tmamba._scan_chunk(h0, a, b)
        h, want = h0, []
        for t in range(length):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        assert _rel(hs, torch.stack(want, 1)) < 1e-6
        assert torch.equal(last, hs[:, -1])


def test_mamba_apply_and_decode_fp32(mamba_params, fp32):
    """``mamba_apply`` on 37 tokens, then three ``mamba_decode`` steps from
    the state JAX's prefill leaves; fp32 throughout, 1e-5."""
    cfg, tcfg, jp, tp = mamba_params
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    assert _rel(tmamba.mamba_apply(tp, tcfg, _t(x)),
                jmamba.mamba_apply(jp, cfg, jnp.asarray(x))) < 1e-5
    _, conv_state, h = tmamba._mamba_forward(tp, tcfg, _t(x))
    jc = jmamba.MambaCache(jnp.asarray(conv_state.numpy()),
                           jnp.asarray(h.numpy()))
    tc = tmamba.MambaCache(conv_state, h)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = jmamba.mamba_decode(jp, cfg, jnp.asarray(xt), jc)
        got, tc = tmamba.mamba_decode(tp, tcfg, _t(xt), tc)
        assert _rel(got, want) < 1e-5, step
        assert _rel(tc.conv, jc.conv) < 1e-6 and _rel(tc.ssm, jc.ssm) < 1e-5
    assert tc.ssm.dtype == torch.float32


def test_mamba_cache_is_fp32():
    tcfg = get_config(JAMBA, smoke=True)
    c = tmamba.init_mamba_cache(tcfg, 3)
    want = jmamba.init_mamba_cache(jax_get_config(JAMBA, smoke=True), 3)
    assert tuple(c.conv.shape) == want.conv.shape
    assert tuple(c.ssm.shape) == want.ssm.shape
    assert c.conv.dtype == c.ssm.dtype == torch.float32


# -- rwkv6 -------------------------------------------------------------------


RWKV = "rwkv6-3b"


@pytest.fixture(scope="module")
def rwkv_params():
    cfg = jax_get_config(RWKV, smoke=True)
    jp = jrwkv.rwkv_init(jax.random.PRNGKey(0), cfg)
    return cfg, get_config(RWKV, smoke=True), jp, _tree(jp)


def test_chunked_wkv(rwkv_params):
    """S = 70 at chunk 32 (three chunks, the last one padded), a nonzero
    entering state and real decays; fp32, 1e-5 for y and the state."""
    cfg, _, jp, _ = rwkv_params
    rng = np.random.default_rng(4)
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    r, k, v = (rng.standard_normal((2, 70, h, dh)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (2, 70, h, dh)).astype(np.float32)
    u = 0.1 * rng.standard_normal((h, dh)).astype(np.float32)
    s0 = rng.standard_normal((2, h, dh, dh)).astype(np.float32)
    wy, ws = jrwkv._chunked_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                            s0)))
    gy, gs = trwkv._chunked_wkv(*(_t(a) for a in (r, k, v, w, u, s0)))
    assert gy.shape == wy.shape and gs.shape == ws.shape
    assert _rel(gy, wy) < 1e-5 and _rel(gs, ws) < 1e-5


def test_rwkv_mixes_and_decodes_fp32(rwkv_params, fp32):
    """Time- and channel-mix over 40 tokens (two chunks) from a carried
    state and shift, then three single-token decodes of each; fp32, 1e-5
    for outputs, states and shifts."""
    cfg, tcfg, jp, tp = rwkv_params
    rng = np.random.default_rng(5)
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    st = 0.3 * rng.standard_normal((2, h, dh, dh)).astype(np.float32)
    last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = jrwkv.rwkv_time_mix(jp, cfg, jnp.asarray(x),
                               state=jnp.asarray(st), last=jnp.asarray(last))
    got = trwkv.rwkv_time_mix(tp, tcfg, _t(x), state=_t(st), last=_t(last))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
    want_c = jrwkv.rwkv_channel_mix(jp, cfg, jnp.asarray(x),
                                    last=jnp.asarray(last))
    got_c = trwkv.rwkv_channel_mix(tp, tcfg, _t(x), last=_t(last))
    for g, w in zip(got_c, want_c):
        assert _rel(g, w) < 1e-5

    jc = jrwkv.RwkvCache(want[1], want[2], want_c[1])
    tc = trwkv.RwkvCache(got[1], got[2], got_c[1])
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        wout, wstate, wlast = jrwkv.rwkv_time_decode(jp, cfg,
                                                     jnp.asarray(xt), jc)
        gout, gstate, glast = trwkv.rwkv_time_decode(tp, tcfg, _t(xt), tc)
        assert _rel(gout, wout) < 1e-5 and _rel(gstate, wstate) < 1e-5
        wco, wcl = jrwkv.rwkv_channel_decode(jp, cfg, jnp.asarray(xt), jc)
        gco, gcl = trwkv.rwkv_channel_decode(tp, tcfg, _t(xt), tc)
        assert _rel(gco, wco) < 1e-5, step
        jc = jrwkv.RwkvCache(wstate, wlast, wcl)
        tc = trwkv.RwkvCache(gstate, glast, gcl)
    assert tc.state.dtype == torch.float32


def test_rwkv_cache_is_fp32():
    c = trwkv.init_rwkv_cache(get_config(RWKV, smoke=True), 2)
    want = jrwkv.init_rwkv_cache(jax_get_config(RWKV, smoke=True), 2)
    for got, ref in zip(c, want):
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32


# -- cross-attention ---------------------------------------------------------


def test_repeat_kv():
    k = np.random.default_rng(6).standard_normal((2, 5, 3, 4)
                                                  ).astype(np.float32)
    for n_rep in (1, 2, 4):
        assert np.array_equal(_np(tattn._repeat_kv(_t(k), n_rep)),
                              np.asarray(jattn._repeat_kv(jnp.asarray(k),
                                                          n_rep)))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "chameleon-34b"],
                         ids=["mha", "gqa-qk-norm"])
def test_cross_attention(arch, fp32):
    """``attn_apply(cross_kv=)``: 7 queries over a 11-position memory,
    no RoPE on the queries, qk-norm on chameleon's; fp32, 1e-5."""
    cfg, tcfg = jax_get_config(arch, True), get_config(arch, True)
    jp = jattn.attn_init(jax.random.PRNGKey(1), cfg)
    tp = _tree(jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, 11, cfg.kv_heads, cfg.head_dim)
                              ).astype(np.float32) for _ in range(2)]
    pos = np.arange(7)
    want = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                            cross_kv=tuple(jnp.asarray(a) for a in kv))
    got = tattn.attn_apply(tp, tcfg, _t(x), _t(pos),
                           cross_kv=tuple(_t(a) for a in kv))
    assert _rel(got, want) < 1e-5
    # the queries ignore positions: shifted positions change nothing
    assert torch.equal(got, tattn.attn_apply(
        tp, tcfg, _t(x), _t(pos + 5), cross_kv=tuple(_t(a) for a in kv)))


# -- whole decoders ----------------------------------------------------------


ARCHS = ["rwkv6-3b", "mixtral-8x7b", "granite-34b", "llama3.2-3b",
         "chameleon-34b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params)
    of one smoke arch, the port's params carried over from JAX's."""
    arch = request.param
    cfg = jax_get_config(arch, smoke=True)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_config(arch, smoke=True)
    return (cfg, jmodel, jparams, tcfg, build_model(tcfg, device="cpu"),
            lm_params_from_jax(jparams, tcfg, device="cpu"))


def test_converter_unstacks_every_layer(pair):
    """Layer ``r * len(period) + j`` of a segment is repeat ``r`` of period
    position ``j`` in JAX's stacked layout, every leaf equal (rwkv's
    channel-mix params inside its ``mixer`` included)."""
    cfg, _, jparams, _, _, tparams = pair
    layer = 0
    for seg, (period, count) in zip(jparams["blocks"], cfg.segments()):
        for r in range(count):
            for j in range(len(period)):
                got = jax.tree.leaves(jax.tree.map(
                    _np, tparams["blocks"][layer]))
                want = [np.asarray(a)[r] for a in jax.tree.leaves(seg[j])]
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                layer += 1
    assert layer == len(tparams["blocks"]) == cfg.n_layers


def _lm_case(pair, tol):
    """Logits and loss on a batch of 2 x 12, then a 9-token prefill and
    three decode steps of the same batch, each within ``tol`` of the
    largest logit (loss: ``tol`` relative).  ``pair`` is the fixture's
    tuple."""
    cfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab, size=(2, 12))
    targets = rng.integers(0, cfg.vocab, size=(2, 12))
    assert _rel(tmodel.logits(tparams, tokens),
                jmodel.logits(jparams, jnp.asarray(tokens))) < tol
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                     "targets": jnp.asarray(targets)})
    tloss, _ = tmodel.loss(tparams, {"tokens": tokens, "targets": targets})
    assert abs(float(tloss) - float(jloss)) < tol * abs(float(jloss))
    # fp32 runs keep an fp32 K/V cache: a bf16 cache would round the two
    # packages' fp32 K/V apart at rounding boundaries
    jdt, tdt = ((jnp.float32, torch.float32) if tol < 1e-3
                else (jnp.bfloat16, torch.bfloat16))
    jcache = jmodel.init_cache(2, 16, dtype=jdt)
    tcache = tmodel.init_cache(2, 16, dtype=tdt)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :9]), jcache)
    tl, tcache = tmodel.prefill(tparams, tokens[:, :9], tcache)
    assert tl.shape == jl.shape and _rel(tl, jl) < tol
    for t in range(9, 12):
        jl, jcache = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = tmodel.decode_step(tparams, tcache, tokens[:, t:t + 1])
        assert _rel(tl, jl) < tol, t
    assert tcache["pos"].tolist() == [12, 12]
    # recurrent states stay fp32 whatever the cache's dtype
    for layer in tcache["layers"]:
        for name, leaf in layer.items():
            if name not in ("k", "v"):
                assert leaf.dtype == torch.float32, name


#: bf16 bound per arch, relative to the largest logit (module docstring)
BF16_TOL = {"rwkv6-3b": 6e-2}


def test_decoder_bf16(pair):
    """As served (bf16 activations); 3e-2, rwkv6 6e-2 (module
    docstring)."""
    _lm_case(pair, BF16_TOL.get(pair[0].name, 3e-2))


def test_decoder_fp32(pair, fp32):
    """fp32 compute in both packages; 1e-4."""
    _lm_case(pair, 1e-4)


# -- the port's own consistency, every arch (mirrors test_models_decode) -----


TOL = 3e-2


def _consistency_cfg(arch):
    """Smoke config; MoE archs with every expert selected and dense
    dispatch, which removes the routing boundary bf16 noise can flip."""
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.num_experts,
                                         strategy="scatter"))
    return cfg


DECODER_ARCHS = [a for a in JAX_ARCH_IDS if a != "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_forward(arch):
    """Decoding a sequence token by token gives the forward's logits, 3e-2
    of the largest."""
    cfg = _consistency_cfg(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 10))
    full = model.logits(params, tok).float()
    cache = model.init_cache(2, max_seq=24)
    outs = []
    for t in range(10):
        logits, cache = model.decode_step(params, cache, tok[:, t:t + 1])
        outs.append(logits.float())
    assert _rel(torch.cat(outs, 1), full) < TOL


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b", JAMBA,
                                  "mixtral-8x7b"])
def test_prefill_then_decode(arch):
    """Prefill 6 tokens, decode 4: every step's logits within 3e-2 of the
    forward's largest logit."""
    cfg = _consistency_cfg(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 10))
    full = model.logits(params, tok).float()
    scale = float(full.abs().max())
    cache = model.init_cache(2, max_seq=24)
    logits, cache = model.prefill(params, tok[:, :6], cache)
    assert float((logits[:, 0].float() - full[:, 5]).abs().max()) \
        < TOL * scale
    for t in range(6, 10):
        logits, cache = model.decode_step(params, cache, tok[:, t:t + 1])
        assert float((logits[:, 0].float() - full[:, t]).abs().max()) \
            < TOL * scale, t


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_every_arch(arch):
    """Every registered arch builds on the CPU, initializes, and gives
    finite logits of the expected shape."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, size=(1, 5))
    if cfg.kind == "encdec":
        assert isinstance(model, EncDec)
        frames = np.random.default_rng(3).standard_normal(
            (1, 4, cfg.d_model)).astype(np.float32)
        logits, _ = model.prefill(params, {"frames": frames,
                                           "tokens": tok[:, :1]},
                                  model.init_cache(1, 8))
        assert tuple(logits.shape) == (1, 1, cfg.vocab)
    else:
        logits = model.logits(params, tok)
        assert tuple(logits.shape) == (1, 5, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
