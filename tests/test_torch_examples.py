"""The port's examples on ``--device cpu`` at a small size, each held to the
JAX package on the same inputs.

- quickstart: every apply within 1e-4 of the fp64 product (the example's
  own oracle, independent of both packages).
- moe_dataflows: the example's MoE layer with the JAX example's params
  (``moe_init`` from key 0) and one numpy-seeded bf16 input; each strategy
  against JAX's same strategy to 2e-2 of the output's largest magnitude.
  The output is bf16, so one element a bf16 ulp (2**-8) apart is expected;
  a token sent to a wrong expert, or a wrong gate, moves its row by the
  size of the output.
- serve_batch: JAX's ``repro.launch.serve.main`` with the example's flags
  and the port's example on JAX's weights (key 0, converted; the test
  puts them in place of the port's random init) give the same tokens for
  every request.
- train_lm: the port's example from JAX's initial state (key 0,
  converted, in place of the port's random init in both runs) against
  JAX's trainer and data pipeline over the same steps, with the restart:
  the second run starts a fresh state from the first run's last params,
  as ``repro.launch.train --resume`` does.  Each loss to 1e-5
  relative.  (``repro.launch.train.main`` itself raises a
  ``ShardingTypeError`` in its embedding gather on the installed jax, so
  the test runs its loop without the mesh.)

serve_batch and train_lm compute ``dense`` and ``embedding_lookup`` in fp32
in both packages (the ``fp32`` fixture): in bf16 two greedy requests of ten
part at a near-tie of the top two logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import make_batch_iterator as jax_batches
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.examples import (moe_dataflows, quickstart, serve_batch,
                                  train_lm)
from repro_torch.launch import train as train_driver
from repro_torch.models.lm import LM
from test_torch_zoo import fp32  # noqa: F401 (a fixture)

MOE_TOL = 2e-2
LOSS_RTOL = 1e-5


def test_quickstart_on_cpu():
    out = quickstart.main(["--device", "cpu"])
    assert out["worst_err"] <= quickstart.TOL
    assert out["kernel_launches"] == 0          # plain versions on the CPU


def test_moe_dataflows_on_cpu():
    cfg = moe_dataflows.CFG
    jcfg = JaxModelConfig(
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(JaxModelConfig) if f.name != "moe"},
        moe=JaxMoEConfig(**dataclasses.asdict(cfg.moe)))
    jparams = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jparams)
    for tokens in (64, 256):
        x = np.random.default_rng(tokens).standard_normal(
            (1, tokens, cfg.d_model)).astype(np.float32)
        outs, _, launches = moe_dataflows.run_strategies(
            params, torch.as_tensor(x).to(torch.bfloat16),
            torch.device("cpu"))
        assert launches["sort"] == 0             # K3's plain version
        for strat in moe_dataflows.STRATEGIES:
            want = np.asarray(jmoe.moe_apply(
                jparams, jcfg, jnp.asarray(x, jnp.bfloat16),
                strategy=strat), np.float32)
            got = outs[strat].float().numpy()
            assert got.shape == want.shape
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < MOE_TOL, (tokens, strat, err)


def test_serve_batch_on_cpu(fp32, monkeypatch):
    arch, n = "qwen2-1.5b", 10
    want = jax_serve.main(["--arch", arch, "--smoke", "--requests", str(n),
                           "--slots", "4", "--max-new", "12"])
    jparams = jax_build_model(jax_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0))
    params = lm_params_from_jax(jparams, get_config(arch, smoke=True),
                                device="cpu")
    monkeypatch.setattr(LM, "init", lambda self, seed=0: params)
    got = serve_batch.main(["--device", "cpu", "--arch", arch, "--requests",
                            str(n)])
    assert sorted(got) == list(range(n))
    assert all(len(v) == 12 for v in got.values())
    assert got == want


def _jax_losses(arch, tcfg, steps):
    """The example's two runs on JAX's trainer: steps ``[0, steps // 2)``
    from key 0's state, then a fresh state holding those params for
    ``[steps // 2, steps)``, each on the data stream at its step."""
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    init = jax_init_train_state(model, jax.random.PRNGKey(tcfg.seed), tcfg)
    step_fn = jax.jit(jax_make_train_step(model, tcfg))
    losses, state = [], init
    for start, stop in ((0, steps // 2), (steps // 2, steps)):
        it = jax_batches(cfg, tcfg, start_step=start)
        for _ in range(start, stop):
            batch = {k: jnp.asarray(v) for k, v in next(it).items()}
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
        it.close()
        state = init._replace(params=state.params)
    return init, losses


def test_train_lm_on_cpu(fp32, monkeypatch):
    arch, steps, batch, seq = "smollm-360m", 4, 4, 32
    # the example's TrainConfig for these flags
    tcfg = JaxTrainConfig(global_batch=batch, seq_len=seq, lr=5e-3,
                          warmup_steps=max(1, steps // 10),
                          total_steps=steps, microbatches=2)
    init, want = _jax_losses(arch, tcfg, steps)
    cfg = get_config(arch, smoke=True)
    monkeypatch.setattr(train_driver, "init_train_state", lambda *a: (
        train_state_from_jax(init, cfg, device="cpu")))
    first, second = train_lm.main(
        ["--device", "cpu", "--arch", arch, "--steps", str(steps),
         "--batch", str(batch), "--seq", str(seq)])
    assert [r["step"] for r in first] == [0, 1]
    assert [r["step"] for r in second] == [2, 3]
    got = [r["loss"] for r in first + second]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
