"""One train step of the port against the JAX package's, in fp32, and a
short loss trajectory.

Both packages' ``dense`` and ``embedding_lookup`` compute in fp32 for these
tests (the ``fp32`` fixture); JAX's smoke params (key 0) are carried into
the port with ``repro_torch.convert``, and the same numpy batch goes
through both.  Tolerances:

- one step: the loss to 1e-5 relative, each leaf's gradient within 1e-4 of
  that leaf's largest magnitude;
- three full steps (clip, LR, AdamW): each step's loss to 1e-4 relative.

The cases are JAX's ``test_smoke_train_step`` list (smollm with two
microbatches under each ``remat`` policy, granite's MoE with ``einsum`` and
with ``sort`` dispatch — the port's K3 Function against ``ragged_dot`` —,
rwkv6, jamba and seamless, the last two ``slow`` as in
``tests/test_system.py``).  Parameters after a step are not compared
element by element: AdamW's first step is about ``lr * sign(g)``, which is
ill-conditioned where |g| is near its eps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer

from repro_torch.checkpoint.checkpointer import tree_flatten
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.train import make_train_step, trainer as ttrainer
from test_torch_train import _batch, _paths, _port_model, _port_tree
from test_torch_zoo import fp32  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this module: the smoke models' ops are small,
    and several test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


_JAX = {}


def _jax_model(arch, strategy=None):
    """JAX's smoke model and its params from key 0, cached per arch and
    MoE strategy."""
    key = (arch, strategy)
    if key not in _JAX:
        cfg = jax_get_config(arch, smoke=True)
        if strategy is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, strategy=strategy))
        model = jax_build_model(cfg)
        _JAX[key] = (model, model.init(jax.random.PRNGKey(0)))
    return _JAX[key]


def _jax_loss_and_grads(jmodel, jparams, batch, microbatches, remat):
    """The reference trainer's ``grads_of``, eager: per-microbatch
    ``value_and_grad`` summed in fp32, times 1/m."""
    batch = jax.tree.map(jnp.asarray, batch)
    vg = jax.value_and_grad(
        lambda p, mb: jmodel.loss(p, mb, remat=remat)[0])
    if microbatches == 1:
        return vg(jparams, batch)
    size = batch["tokens"].shape[0] // microbatches
    l_sum, g_sum = 0.0, None
    for i in range(microbatches):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, g = vg(jparams, mb)
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        g_sum = g if g_sum is None else jax.tree.map(jnp.add, g_sum, g)
        l_sum = l_sum + loss
    inv = 1.0 / microbatches
    return l_sum * inv, jax.tree.map(lambda g: g * inv, g_sum)


_heavy = lambda *a: pytest.param(*a, marks=pytest.mark.slow)
STEP_CASES = [
    ("smollm-360m", None, 2, True),
    ("smollm-360m", None, 2, "dots"),
    ("smollm-360m", None, 2, False),
    ("granite-moe-1b-a400m", "einsum", 1, True),
    ("granite-moe-1b-a400m", "sort", 1, True),
    ("rwkv6-3b", None, 1, True),
    _heavy("jamba-v0.1-52b", None, 1, True),
    _heavy("seamless-m4t-large-v2", None, 1, True),
]


@pytest.mark.parametrize("arch,strategy,microbatches,remat", STEP_CASES)
def test_train_step_grads_match_jax(arch, strategy, microbatches, remat,
                                    fp32):
    """One step's loss and every leaf's gradient, the port (autograd, its
    ``sort`` MoE through K3's Function) against JAX (``jax.grad``, its
    ``sort`` through ``ragged_dot``), in fp32."""
    jmodel, jparams = _jax_model(arch, strategy)
    model = _port_model(arch, strategy)
    cfg = model.cfg
    batch = _batch(cfg)
    tcfg = TrainConfig(global_batch=4, seq_len=16,
                       microbatches=microbatches, remat=remat)
    jl, jg = _jax_loss_and_grads(jmodel, jparams, batch, microbatches, remat)
    loss, grads = ttrainer.loss_and_grads(model, tcfg,
                                          _port_tree(jparams, cfg), batch)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    want = _port_tree(jg, cfg)
    for path, a, b in zip(_paths(grads), tree_flatten(grads),
                          tree_flatten(want)):
        assert a.dtype == torch.float32 and a.shape == b.shape, path
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) / scale < 1e-4, path


def test_loss_trajectory_matches_jax(fp32):
    """Three full steps (clip, LR, AdamW) of both trainers from the same
    state: each step's loss to 1e-4 relative, and the step counters."""
    arch = "smollm-360m"
    jmodel, jparams = _jax_model(arch)
    model = _port_model(arch)
    kw = dict(global_batch=4, seq_len=16, lr=3e-3, warmup_steps=1,
              total_steps=10, microbatches=2)
    jstep = jtrainer.make_train_step(jmodel, JaxTrainConfig(**kw))
    tstep = make_train_step(model, TrainConfig(**kw))
    jstate = jtrainer.TrainState(jparams, jopt.adamw_init(jparams), None)
    tstate = train_state_from_jax(jstate, model.cfg, device="cpu")
    for i in range(3):
        batch = _batch(model.cfg, step=i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(tm["step"]) == int(jm["step"]) == i + 1


