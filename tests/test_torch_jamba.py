"""jamba (the mamba/attention hybrid with MoE) and the serving engine on
the recurrent stacks, against the JAX package.

One module fixture holds JAX's jamba smoke model (8 layers: 7 mamba, 1
attention, 4 MoE layers of 4 experts top-2), its parameters and the port's
copy of them.  Tolerances, relative to the largest logit:

- fp32 (both packages' ``dense`` and ``embedding_lookup`` switched to fp32
  for the test): 1e-4, with jamba's own top-2 routing.
- bf16, as served: 8e-2, with every expert selected and dense dispatch
  (a top-2 route is a discrete boundary a bf16 difference can flip, as
  ``tests/test_models_decode.py`` notes).  Seven mamba layers each round
  their gates, conv and projections to bf16, where XLA on the CPU fuses
  some elementwise chains in fp32; on these inputs the two packages land
  more than 3e-2 and less than 5e-2 apart, while the fp32 test holds them
  to 1e-4.

The serving tests run ``ServeEngine`` on the jamba and rwkv6 smokes against
its own greedy reference (exact tokens) and against the JAX engine.  The
JAX engine jits its decode step, so the fp32 comparison gives its model a
config name of its own: no trace made under the fp32 switch can be reused
by another test's model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from test_torch_zoo import _lm_case, _np, fp32  # noqa: F401 (a fixture)

JAMBA = "jamba-v0.1-52b"


def _all_experts(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.num_experts, strategy="scatter"))


@pytest.fixture(scope="module")
def jamba():
    """JAX's jamba smoke params and the port's copy; the segments give one
    period of 8 layers, unstacked by the converter."""
    cfg = jax_get_config(JAMBA, smoke=True)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = get_config(JAMBA, smoke=True)
    tparams = lm_params_from_jax(jparams, tcfg, device="cpu")
    return cfg, jparams, tcfg, tparams


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: _np(tree)}


def test_converter_unstacks_the_hybrid_period(jamba):
    """The smoke's one period of 8 layers (repeat count 1; the full config
    repeats it 4 times) lands as 8 block dicts, each leaf equal to its
    period position's repeat 0 in JAX's stacked layout."""
    cfg, jparams, tcfg, tparams = jamba
    assert [len(p) for p, _ in cfg.segments()] == [8]
    assert [c for _, c in cfg.segments()] == [1]
    assert [c for _, c in get_config(JAMBA).segments()] == [4]
    assert len(tparams["blocks"]) == cfg.n_layers
    for i, block in enumerate(tparams["blocks"]):
        mixer, ffn = cfg.layer_signature(i)
        assert ("a_log" in block["mixer"]) == (mixer == "mamba")
        assert ("router" in block["ffn"]) == (ffn == "moe")
        got = _flat(block)
        want = {k: v[0] for k, v in _flat(jparams["blocks"][0][i]).items()}
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pair(cfg, jparams, tcfg, tparams):
    return (cfg, jax_build_model(cfg), jparams, tcfg,
            build_model(tcfg, device="cpu"), tparams)


def test_jamba_fp32(jamba, fp32):
    """jamba's own routing (top-2 of 4, ``einsum``) in fp32; 1e-4."""
    _lm_case(_pair(*jamba), 1e-4)


def test_jamba_bf16(jamba):
    """As served, every expert selected; 8e-2 (module docstring)."""
    cfg, jparams, tcfg, tparams = jamba
    _lm_case(_pair(_all_experts(cfg), jparams, _all_experts(tcfg), tparams),
             8e-2)


# -- serving -----------------------------------------------------------------


def _greedy(model, params, prompt, n_new, max_seq=32, dtype=torch.bfloat16):
    """Batch-1 prefill then decode; returns (tokens, logits per step)."""
    cache = model.init_cache(1, max_seq, dtype)
    logits, cache = model.prefill(params, np.asarray(prompt)[None], cache)
    toks, steps = [], []
    for i in range(n_new):
        row = logits[0, -1].float()
        steps.append(row)
        toks.append(int(torch.argmax(row)))
        if i < n_new - 1:
            logits, cache = model.decode_step(params, cache,
                                              np.asarray([[toks[-1]]]))
    return toks, steps


@pytest.mark.parametrize("arch", [JAMBA, "rwkv6-3b"])
def test_engine_matches_greedy_reference(arch):
    """More requests than slots, mixed prompt lengths, reused slots: every
    request equals its isolated batch-1 decode exactly; the slots'
    recurrent states stay fp32 under the engine's bf16."""
    model = build_model(get_config(arch, smoke=True), device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, size=int(n))
               for n in rng.integers(3, 12, size=5)]
    eng = ServeEngine(model, params, slots=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, max_new_tokens=4))
    results = eng.run_to_completion()
    assert eng.stats["completed"] == len(prompts) == len(results)
    for rid, p in enumerate(prompts):
        assert results[rid] == _greedy(model, params, p, 4)[0], rid
    assert not eng.cache["pos"].any()
    for layer in eng.cache["layers"]:
        for name, leaf in layer.items():
            if name not in ("k", "v"):
                assert leaf.dtype == torch.float32, name


#: top-1 over top-2 margin each greedy step must keep, relative to the
#: step's largest logit, for a token-for-token comparison in fp32 to mean
#: something (the packages differ by ~1e-6 there)
MARGIN = 1e-3


@pytest.mark.parametrize("arch", [JAMBA, "rwkv6-3b"])
def test_port_and_jax_engines_agree_fp32(arch, fp32):
    """Both engines, 2 slots, three prompts of 3-9 tokens, 3 new tokens
    each, in fp32 with fp32 caches: the same tokens (each step's margin
    asserted)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               name=f"{arch}-fp32-engine-test")
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               name=jcfg.name)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = lm_params_from_jax(jparams, tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, size=int(n))
               for n in rng.integers(3, 10, size=3)]
    for p in prompts:
        for row in _greedy(tmodel, tparams, p, 3, dtype=torch.float32)[1]:
            top = torch.sort(row).values
            assert float(top[-1] - top[-2]) > MARGIN * float(row.abs().max())
    jeng = JaxServeEngine(jmodel, jparams, slots=2, max_seq=32,
                          dtype=jnp.float32)
    teng = ServeEngine(tmodel, tparams, slots=2, max_seq=32,
                       dtype=torch.float32)
    for rid, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid, p, max_new_tokens=3))
        teng.submit(Request(rid, p, max_new_tokens=3))
    assert teng.run_to_completion() == jeng.run_to_completion()


def test_launch_serve_cli_recurrent_archs(capsys):
    """``python -m repro_torch.launch.serve`` serves the recurrent smokes;
    ``--arch`` refuses the encoder-decoder, which the engine does not
    serve."""
    from repro_torch.launch import serve

    assert "seamless-m4t-large-v2" not in serve.SERVABLE
    assert len(serve.SERVABLE) == 9
    for arch in ("rwkv6-3b", JAMBA):
        results = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--max-new", "2"])
        assert sorted(results) == [0, 1, 2]
        assert all(len(v) == 2 for v in results.values())
    assert "decode_step p50" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                    "--device", "cpu"])
