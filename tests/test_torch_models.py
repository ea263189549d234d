"""The port's model modules against their JAX counterparts.

Same numpy-seeded inputs and the same parameters (JAX's, carried over with
``repro_torch.convert.lm_params_from_jax``) through both packages, on the
CPU.  Tolerances:

- fp32 paths (norms, rope, blockwise attention, the three MoE strategies):
  ``rtol = atol = 1e-4`` as in the JAX package's tests, or tighter where
  the computation is elementwise;
- bf16 paths (attention decode, LM logits): both packages round the same
  products to bf16 (8 significant bits, 2**-8 relative) at a handful of
  points per layer, but their fp32 sums inside a product differ in order,
  so a value near a rounding boundary can land one bf16 ulp apart and the
  difference then propagates.  The bound is stated per test, relative to
  the output's largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.backends import get_policy as jax_get_policy

from repro_torch.backends import get_policy
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe


ARCH = "granite-moe-1b-a400m"


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


#: (arch, smoke) -> the fields whose values the port's config takes from
#: the published model where the JAX config has other ones
PUBLISHED = {("granite-moe-1b-a400m", False): {"norm_eps": 1e-6}}


def test_configs_match_the_reference():
    """Every config equals JAX's but for the port's own field, ``scales``
    (a model's muP scalars, which the JAX config lacks: None on every
    config but granite's full one), and granite's published RMSNorm
    epsilon."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS
    for name in ARCH_IDS:
        for smoke in (False, True):
            port = dataclasses.asdict(get_config(name, smoke))
            scales = port.pop("scales")
            assert (scales is None) == ((name, smoke) not in PUBLISHED)
            want = dataclasses.asdict(jax_get_config(name, smoke))
            published = PUBLISHED.get((name, smoke), {})
            assert {k: port[k] for k in published} == published
            assert {k: v for k, v in port.items() if k not in published} \
                == {k: v for k, v in want.items() if k not in published}


# -- layers ------------------------------------------------------------------


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tlayers.rmsnorm({"scale": _t(scale)}, _t(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)

    for positions in (np.arange(5), np.array([[0, 1, 2, 3, 4],
                                              [7, 8, 9, 10, 11]])):
        jc, js = jlayers.rope(jnp.asarray(positions), 16, 1e4)
        tc, ts = tlayers.rope(_t(positions), 16, 1e4)
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            _np(tlayers.apply_rope(_t(x), tc, ts)),
            _np(jlayers.apply_rope(jnp.asarray(x), jc, js)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=5),
    dict(causal=False),
    dict(causal=True, gqa_native=True),
    dict(causal=True, q_offset=3, window=4, gqa_native=True),
], ids=["causal", "window", "full", "gqa-native", "offset-window"])
def test_blockwise_attention(kw):
    """fp32 in, several q and k blocks (ragged last ones), GQA 4:2."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 11, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 11 + kw.get("q_offset", 0), 2, 8)
                            ).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    blocks = dict(block_q=4, block_k=6)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **blocks, **kw)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), **blocks, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def _smoke_lm(strategy=None):
    cfg = jax_get_config(ARCH, smoke=True)
    if strategy is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, strategy=strategy))
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        get_config(ARCH, smoke=True),
        moe=dataclasses.replace(get_config(ARCH, smoke=True).moe,
                                strategy=cfg.moe.strategy))
    tparams = lm_params_from_jax(jparams, tcfg, device="cpu")
    return cfg, jmodel, jparams, tcfg, build_model(tcfg, device="cpu"), \
        tparams


def test_attn_decode_with_per_slot_positions():
    """bf16 projections; bound 2e-2 of the output's largest magnitude."""
    cfg, _, jparams, tcfg, _, tparams = _smoke_lm()
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0][0]["mixer"])
    tp = tparams["blocks"][0]["mixer"]
    rng = np.random.default_rng(2)
    b, s_max = 3, 12
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    k0 = rng.standard_normal((b, s_max, cfg.kv_heads, cfg.head_dim))
    v0 = rng.standard_normal(k0.shape)
    pos = np.array([0, 5, 11], np.int32)
    jc = jattn.AttnCache(jnp.asarray(k0, jnp.bfloat16),
                         jnp.asarray(v0, jnp.bfloat16))
    tc = tattn.AttnCache(torch.as_tensor(k0).to(torch.bfloat16),
                         torch.as_tensor(v0).to(torch.bfloat16))
    want, jnew = jattn.attn_decode(jp, cfg, jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(pos), jc)
    got, tnew = tattn.attn_decode(tp, tcfg, _t(x).to(torch.bfloat16),
                                  _t(pos), tc)
    assert _rel(got, want) < 2e-2
    assert _rel(tnew.k, jnew.k) < 2e-2 and _rel(tnew.v, jnew.v) < 2e-2


# -- MoE ---------------------------------------------------------------------


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["roomy", "drops"])
@pytest.mark.parametrize("strategy", ["einsum", "scatter", "sort"])
def test_moe_strategies_fp32(strategy, cf):
    """Each strategy against JAX's own, fp32, rtol = atol = 1e-4; the port's
    sort runs K3's plain version where JAX runs ``ragged_dot``."""
    from repro.configs.base import ModelConfig, MoEConfig
    from repro_torch.configs.base import ModelConfig as TModelConfig
    from repro_torch.configs.base import MoEConfig as TMoEConfig

    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              d_ff=48, vocab=64)
    moe = dict(num_experts=4, top_k=2, capacity_factor=cf)
    jcfg = ModelConfig(**kw, moe=MoEConfig(**moe))
    tcfg = TModelConfig(**kw, moe=TMoEConfig(**moe))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = jax.tree.map(lambda a: _t(a), jp)
    x = np.random.default_rng(3).standard_normal((2, 24, 32)
                                                 ).astype(np.float32)
    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), strategy=strategy)
    got = tmoe.moe_apply(tp, tcfg, _t(x), strategy=strategy)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_strategy_selection_agrees():
    jcfg = jax_get_config(ARCH)
    tcfg = get_config(ARCH)
    for t in (1, 2, 4, 8, 16, 32, 128, 512, 4096, 65536):
        for cfg_j, cfg_t in ((jcfg, tcfg),
                             (jax_get_config(ARCH, True),
                              get_config(ARCH, True))):
            args = (t, cfg_t.d_model, cfg_t.d_ff, cfg_t.moe.num_experts,
                    cfg_t.moe.top_k)
            assert tmoe.select_moe_strategy(*args) \
                == jmoe.select_moe_strategy(*args)
            auto_j = dataclasses.replace(
                cfg_j, moe=dataclasses.replace(cfg_j.moe, strategy="auto"))
            auto_t = dataclasses.replace(
                cfg_t, moe=dataclasses.replace(cfg_t.moe, strategy="auto"))
            assert tmoe.plan_moe(auto_t, t) == tmoe.MoEPlan(
                jmoe.plan_moe(auto_j, t).strategy, t)
            for d in ("ip_m", "op_n", "gust_m"):
                assert tmoe.plan_moe(auto_t, t, policy=get_policy(d)
                                     ).strategy \
                    == jmoe.plan_moe(auto_j, t,
                                     policy=jax_get_policy(d)).strategy


# -- the LM ------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["einsum", "sort"])
def test_lm_prefill_and_decode_logits(strategy):
    """Prefill a 9-token prompt and decode 3 tokens in bf16, with the
    smoke granite config's two MoE layers.  Bound: 3e-2 of the largest
    logit at every step (the bf16 rounding points of two layers, see the
    module docstring)."""
    cfg, jmodel, jparams, tcfg, tmodel, tparams = _smoke_lm(strategy)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, size=(1, 9))
    jcache = jmodel.init_cache(1, 16)
    tcache = tmodel.init_cache(1, 16)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(prompt), jcache)
    tl, tcache = tmodel.prefill(tparams, prompt, tcache)
    assert tl.shape == jl.shape
    assert _rel(tl, jl) < 3e-2
    tok = np.asarray([[int(np.argmax(_np(jl)[0, -1]))]])
    for _ in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok))
        tl, tcache = tmodel.decode_step(tparams, tcache, tok)
        assert _rel(tl, jl) < 3e-2
        tok = np.asarray([[int(np.argmax(_np(jl)[0, -1]))]])
    assert int(tcache["pos"][0]) == int(jcache["pos"][0]) == 12


def test_lm_logits_and_loss_fp32_params():
    """The training forward (``logits``) and ``loss`` on a batch of 2."""
    cfg, jmodel, jparams, tcfg, tmodel, tparams = _smoke_lm()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(2, 7))
    targets = rng.integers(0, cfg.vocab, size=(2, 7))
    jl = jmodel.logits(jparams, jnp.asarray(tokens))
    tl = tmodel.logits(tparams, tokens)
    assert _rel(tl, jl) < 3e-2
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                     "targets": jnp.asarray(targets)})
    tloss, _ = tmodel.loss(tparams, {"tokens": tokens, "targets": targets})
    assert abs(float(tloss) - float(jloss)) < 1e-2 * abs(float(jloss))

