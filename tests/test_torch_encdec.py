"""The port's encoder-decoder (seamless-m4t's smoke config) against the
JAX package.

JAX's params are carried over with ``repro_torch.convert
.encdec_params_from_jax`` (its stacked encoder and decoder become lists of
layer dicts).  Tolerances, relative to the reference's largest magnitude:
bf16 as served 3e-2; fp32 (both packages' ``dense`` and
``embedding_lookup`` switched to fp32, and fp32 caches) 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model

from repro_torch.configs import get_config
from repro_torch.convert import encdec_params_from_jax
from repro_torch.models import EncDec, build_model
from repro_torch.models.layers import dense, embedding_lookup, rmsnorm
from test_torch_zoo import _np, _rel, fp32  # noqa: F401 (a fixture)

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def pair():
    cfg = jax_get_config(ARCH, smoke=True)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH, smoke=True)
    tmodel = build_model(tcfg, device="cpu")
    return (cfg, jmodel, jparams, tcfg, tmodel,
            encdec_params_from_jax(jparams, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def inputs(pair):
    cfg = pair[0]
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(2, 6))
    return frames, tokens


def test_build_model_gives_encdec(pair):
    _, _, _, tcfg, tmodel, tparams = pair
    assert isinstance(tmodel, EncDec) and tmodel.device.type == "cpu"
    assert (tmodel.n_enc, tmodel.n_dec) == (2, 2)
    assert len(tparams["encoder"]) == len(tparams["decoder"]) == 2


def test_converter_unstacks_both_stacks(pair):
    _, _, jparams, _, _, tparams = pair
    for stack in ("encoder", "decoder"):
        for r, layer in enumerate(tparams[stack]):
            got = jax.tree.leaves(jax.tree.map(_np, layer))
            want = [np.asarray(a)[r]
                    for a in jax.tree.leaves(jparams[stack])]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(_np(tparams["lm_head"]["w"]),
                                  np.asarray(jparams["lm_head"]["w"]))


def _case(pair, inputs, tol, cache_dtypes):
    cfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    frames, tokens = inputs
    jmem = jmodel.encode(jparams, jnp.asarray(frames), remat=False)
    tmem = tmodel.encode(tparams, frames)
    assert _rel(tmem, jmem) < tol
    batch = {"frames": frames, "tokens": tokens, "targets": np.ascontiguousarray(tokens[:, ::-1])}
    jloss, _ = jmodel.loss(jparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tloss, _ = tmodel.loss(tparams, batch)
    assert abs(float(tloss) - float(jloss)) < tol * abs(float(jloss))

    jcache = jmodel.init_cache(2, 16, dtype=cache_dtypes[0])
    tcache = tmodel.init_cache(2, 16, dtype=cache_dtypes[1])
    jl, jcache = jmodel.prefill(jparams, {"frames": jnp.asarray(frames),
                                          "tokens": jnp.asarray(tokens[:, :1])},
                                jcache)
    tl, tcache = tmodel.prefill(tparams, {"frames": frames,
                                          "tokens": tokens[:, :1]}, tcache)
    assert tl.shape == jl.shape and _rel(tl, jl) < tol
    assert tcache["mem_len"] == int(jcache["mem_len"]) == 8
    for t in range(1, 6):
        jl, jcache = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = tmodel.decode_step(tparams, tcache, tokens[:, t:t + 1])
        assert _rel(tl, jl) < tol, t
    assert tcache["pos"].tolist() == [6, 6]


def test_encdec_bf16(pair, inputs):
    """Encode, loss, BOS prefill and five decode steps, as served; 3e-2."""
    _case(pair, inputs, 3e-2, (jnp.bfloat16, torch.bfloat16))


def test_encdec_fp32(pair, inputs, fp32):
    """The same in fp32 with fp32 caches; 1e-4."""
    _case(pair, inputs, 1e-4, (jnp.float32, torch.float32))


def test_decode_matches_teacher_forced(pair, inputs):
    """The port's BOS prefill and decode steps give the teacher-forced
    decoder's logits (``_decoder_pass`` over the encoder memory), 3e-2 of
    the largest, as tests/test_models_decode.py holds JAX's."""
    _, _, _, tcfg, tmodel, tparams = pair
    frames, tokens = inputs
    mem = tmodel.encode(tparams, frames)
    x = embedding_lookup(tparams["embed"], torch.as_tensor(tokens))
    x = tmodel._decoder_pass(tparams, x, torch.arange(6), mem)
    full = dense(tparams["lm_head"],
                 rmsnorm(tparams["final_norm"], x, tcfg.norm_eps)).float()
    cache = tmodel.init_cache(2, max_seq=24)
    logits, cache = tmodel.prefill(
        tparams, {"frames": frames, "tokens": tokens[:, :1]}, cache)
    outs = [logits.float()]
    for t in range(1, 6):
        logits, cache = tmodel.decode_step(tparams, cache, tokens[:, t:t + 1])
        outs.append(logits.float())
    assert _rel(torch.cat(outs, 1), full) < 3e-2


def test_cross_cache_masks_past_mem_len(pair, inputs):
    """The cross K/V lines are ``max_seq`` long; positions past the memory
    (``mem_len``) are masked, so a longer cache gives the same logits
    (fp32 sums over the masked tail add exact zeros; 1e-6)."""
    _, _, _, _, tmodel, tparams = pair
    frames, tokens = inputs
    runs = []
    for max_seq in (8, 24):
        cache = tmodel.init_cache(2, max_seq)
        logits, cache = tmodel.prefill(
            tparams, {"frames": frames, "tokens": tokens[:, :1]}, cache)
        out = [logits.float()]
        for t in range(1, 4):
            logits, cache = tmodel.decode_step(tparams, cache,
                                               tokens[:, t:t + 1])
            out.append(logits.float())
        runs.append(torch.cat(out, 1))
    assert _rel(runs[1], runs[0]) < 1e-6
