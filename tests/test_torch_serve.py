"""The port's serving engine: against its own greedy reference, the pinned
MoE decode plan, admission-time FFN planning, and the JAX engine."""
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
from repro_torch.models import moe as tmoe
from repro_torch.serve import Request, ServeEngine


@pytest.fixture(autouse=True)
def _no_verify(monkeypatch):
    # the port has no plan verifier yet (ROADMAP item 10): verify=True and
    # REPRO_VERIFY=1 raise, so these tests plan with verification off
    monkeypatch.setenv("REPRO_VERIFY", "0")


ARCH = "granite-moe-1b-a400m"


def _cfg(strategy, jax_side=False):
    cfg = (jax_get_config if jax_side else get_config)(ARCH, smoke=True)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, strategy=strategy))


@pytest.fixture(scope="module")
def sort_model():
    model = build_model(_cfg("sort"), device="cpu")
    return model, model.init(seed=0)


def _greedy(model, params, prompt, n_new, max_seq=32):
    """Batch-1 prefill then decode; returns (tokens, last logits per step)."""
    cache = model.init_cache(1, max_seq)
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


def test_continuous_batching_matches_greedy_reference(sort_model):
    """More requests than slots, mixed prompt lengths, reused slots: every
    request equals its isolated batch-1 decode exactly (sort dispatch, K3's
    plain version on the CPU)."""
    model, params = sort_model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, size=int(n))
               for n in rng.integers(3, 12, size=5)]
    eng = ServeEngine(model, params, slots=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, max_new_tokens=4))
    results = eng.run_to_completion()
    assert eng.stats["completed"] == len(prompts) == len(results)
    assert eng.stats["prefills"] == len(prompts)
    for rid, p in enumerate(prompts):
        assert results[rid] == _greedy(model, params, p, 4)[0], rid
    # freed slots were reset: every position is back to 0
    assert not eng.cache["pos"].any()
    lat = eng.latency_stats()
    assert lat["serve.latency.decode_step_s"]["count"] \
        == eng.stats["decode_steps"]


def test_moe_decode_strategy_planned_once(monkeypatch):
    """An auto-strategy MoE model gets its dispatch planned once for the
    fused decode shape; decode steps never run the selector again, and the
    output equals the reference decode."""
    calls = []
    select = tmoe.select_moe_strategy

    def counting(*args):
        calls.append(args)
        return select(*args)

    monkeypatch.setattr(tmoe, "select_moe_strategy", counting)
    model = build_model(_cfg("auto"), device="cpu")
    params = model.init(seed=0)
    cfg = model.cfg
    eng = ServeEngine(model, params, slots=1, max_seq=32)
    assert len(calls) == 1
    assert eng.moe_plan == tmoe.MoEPlan(select(1, cfg.d_model, cfg.d_ff,
                                               cfg.moe.num_experts,
                                               cfg.moe.top_k), 1)
    assert eng._decode.__self__.cfg.moe.strategy == eng.moe_plan.strategy
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=4)
    eng.submit(Request(0, prompt, max_new_tokens=3))
    out = eng.run_to_completion()[0]
    # the prefill (unpinned, batch 1 x 4 tokens) ran the selector once per
    # MoE layer; the two decode steps not at all
    assert len(calls) == 1 + cfg.n_layers
    assert out == _greedy(model, params, prompt, 3)[0]


def test_sparse_ffn_planned_at_admission():
    """A pruned FFN handed to the engine is specialized for the decode
    shape at construction and once per new prompt length at admission."""
    from repro_torch import compress_ffn

    model = build_model(_cfg("sort"), device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(3)
    fparams = {name: {"w": torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32))}
        for name, shape in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                            ("w_down", (96, 64)))}
    fparams["block_mask"] = torch.as_tensor(
        (rng.random((4, 6)) > 0.4).astype(np.float32))
    comp = compress_ffn(fparams, tokens=2, block=16, backend="reference",
                        device="cpu")
    eng = ServeEngine(model, params, slots=2, max_seq=32, sparse_ffn=comp)
    assert eng.decode_ffn is comp.specialize(2)
    builds = comp.plan_builds
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(0, 256, size=5),
                           max_new_tokens=2))
    eng.run_to_completion()
    assert comp.plan_builds == builds + 1
    assert eng.stats["plan_builds"] == comp.plan_builds
    assert eng.stats["plan_hits"] == comp.plan_hits >= 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.verify_plans()


def test_engine_stats_copy_the_policy_stats():
    """``stats["policy"]`` is a deep copy of the FFN policy's ``stats``, as
    in the JAX engine: autotune's counters, not only its name."""
    from repro_torch import compress_ffn
    from repro_torch.backends import AutotunePolicy

    model = build_model(_cfg("sort"), device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(4)
    fparams = {name: {"w": torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32))}
        for name, shape in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                            ("w_down", (96, 64)))}
    fparams["block_mask"] = torch.as_tensor(
        (rng.random((4, 6)) > 0.4).astype(np.float32))
    pol = AutotunePolicy(reps=1)
    comp = compress_ffn(fparams, tokens=2, block=16, backend="reference",
                        policy=pol, device="cpu")
    eng = ServeEngine(model, params, slots=2, max_seq=32, sparse_ffn=comp)
    stats = eng.stats["policy"]
    assert stats == pol.stats and stats["name"] == "autotune"
    assert stats["measurements"] == pol.measurements >= 1
    stats["hits"] = -1                  # a copy: the policy is untouched
    assert pol.stats["hits"] != -1 and eng.stats["policy"] == pol.stats


#: bound on |port logits - JAX logits| relative to the step's largest
#: logit: bf16 rounding at different points of two MoE layers
#: (tests/test_torch_models.py measures ~1.2e-2 and holds 3e-2 there)
LOGIT_TOL = 2e-2
#: a seed whose three prompts keep every step's top-2 margin above
#: 2 x LOGIT_TOL under both packages, found by search and asserted below
MARGIN_SEED = 32


def test_port_and_jax_engines_agree():
    jcfg = _cfg("sort", jax_side=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = _cfg("sort")
    tmodel = build_model(tcfg, device="cpu")
    tparams = lm_params_from_jax(jparams, tcfg, device="cpu")
    rng = np.random.default_rng(MARGIN_SEED)
    prompts = [rng.integers(0, tcfg.vocab, size=int(n))
               for n in rng.integers(3, 10, size=3)]
    n_new = 3

    # the margin that makes the comparison meaningful, at every step
    for p in prompts:
        cache = jmodel.init_cache(1, 32)
        logits, cache = jmodel.prefill(jparams, jnp.asarray(p)[None], cache)
        _, port_steps = _greedy(tmodel, tparams, p, n_new)
        for i in range(n_new):
            row = np.asarray(logits[0, -1], np.float32)
            top = np.sort(row)
            scale = np.abs(row).max()
            assert top[-1] - top[-2] > 2 * LOGIT_TOL * scale
            assert np.abs(port_steps[i].numpy() - row).max() \
                < LOGIT_TOL * scale
            if i < n_new - 1:
                logits, cache = jmodel.decode_step(
                    jparams, cache, jnp.asarray([[int(np.argmax(row))]]))

    jeng = JaxServeEngine(jmodel, jparams, slots=2, max_seq=32)
    teng = ServeEngine(tmodel, tparams, slots=2, max_seq=32)
    for rid, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid, p, max_new_tokens=n_new))
        teng.submit(Request(rid, p, max_new_tokens=n_new))
    assert teng.run_to_completion() == jeng.run_to_completion()


def test_launch_serve_cli(capsys):
    """``python -m repro_torch.launch.serve`` with the reference's flags
    plus ``--device``."""
    from repro_torch.launch import serve

    results = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "3", "--slots", "2", "--max-new",
                          "2"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(v) == 2 for v in results.values())
    assert "decode_step p50" in capsys.readouterr().out
