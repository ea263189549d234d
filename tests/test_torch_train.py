"""The port's training layer against the JAX package's: AdamW, the LR
schedule, clipping, gradient compression, the weight-decay mask, the train
step and ``launch/train.py``.

Same numpy inputs (and JAX's parameters, carried over with
``repro_torch.convert``) through both packages, on the CPU.  Tolerances:

- optimizer, schedule, clipping and compression: 1e-6 (the same fp32
  formulas in the same order; only sums over leaves run in another order);
- the weight-decay mask and ``train_state_from_jax``: exact (the same
  leaves decay, to 1e-6; every converted leaf bit-equal).

One train step's gradients and a short loss trajectory against JAX live in
``test_torch_train_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer

from repro_torch.checkpoint.checkpointer import tree_flatten
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import (encdec_params_from_jax, lm_params_from_jax,
                                 train_state_from_jax)
from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.compression import (compress_decompress,
                                           init_error_feedback)
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         clip_by_global_norm,
                                         cosine_schedule, decay_mask,
                                         global_norm)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this module: the smoke models' ops are small,
    and several test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _port_tree(tree, cfg):
    """A JAX params-shaped tree (params, grads, moments) in the port's
    layout, on the CPU."""
    conv = encdec_params_from_jax if cfg.kind == "encdec" \
        else lm_params_from_jax
    return conv(tree, cfg, device="cpu")


def _port_model(arch, strategy=None):
    cfg = get_config(arch, smoke=True)
    if strategy is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, strategy=strategy))
    return build_model(cfg, device="cpu")


def _batch(cfg, b=4, s=16, step=0):
    return SyntheticLM(vocab=cfg.vocab, batch=b, seq_len=s, seed=1,
                       frames_dim=cfg.d_model if cfg.frontend == "frames"
                       else None).batch_at(step)


# -- tests/test_train_units.py on the port -------------------------------------


def test_cosine_schedule_shape():
    lr = lambda s: float(cosine_schedule(torch.tensor(s), base_lr=1e-3,
                                         warmup=10, total=100))
    assert lr(0) == 0.0
    assert abs(lr(10) - 1e-3) < 1e-9
    assert lr(5) == pytest.approx(5e-4)
    assert lr(100) == pytest.approx(1e-4, rel=1e-2)
    assert lr(55) < lr(10)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((4,), 0.01)}
    out, _ = clip_by_global_norm(small, 1.0)
    assert np.allclose(out["a"].numpy(), 0.01)


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = adamw_update(params, grads, state, lr=0.05,
                                     weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state.step) == 200 and state.step.dtype == torch.int32


def test_adamw_weight_decay_only_on_matrices():
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    state = adamw_init(params)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _ = adamw_update(params, zero, state, lr=0.1, weight_decay=0.5)
    assert float(new["w"][0, 0]) < 1.0
    assert float(new["b"][0]) == pytest.approx(1.0)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 16))
def test_compression_error_feedback_property(seed):
    rng = np.random.default_rng(seed)
    g = {"w": torch.as_tensor(rng.standard_normal((4, 64)),
                              dtype=torch.float32)}
    ef = init_error_feedback(g)
    total = torch.zeros_like(g["w"])
    steps = 20
    for _ in range(steps):
        deq, ef = compress_decompress(g, ef)
        total = total + deq["w"]
    err = float((total - steps * g["w"]).abs().max())
    scale = float(g["w"].abs().max())
    assert err <= scale / 127.0 * 2 + 1e-5


def test_compression_quantizes_to_int8_grid():
    g = {"w": torch.linspace(-1, 1, 64)[None]}
    deq, _ = compress_decompress(g, init_error_feedback(g))
    scale = g["w"].abs().amax(-1, keepdim=True) / 127.0
    q = (deq["w"] / scale).numpy()
    assert np.allclose(q, np.round(q), atol=1e-4)


# -- the same functions against JAX -------------------------------------------


def _np_tree(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "blocks": {"s": rng.standard_normal((7,)).astype(np.float32),
                       "k": rng.standard_normal((2, 4, 6)).astype(np.float32)}}


def _assert_trees_close(got, want, tol=1e-6):
    for a, b in zip(tree_flatten(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("step", [0, 3, 10, 55, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    kw = dict(base_lr=3e-3, warmup=10, total=100)
    got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw))
    want = float(jopt.cosine_schedule(jnp.asarray(step, jnp.int32), **kw))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_jax(max_norm):
    t = _np_tree(np.random.default_rng(0))
    got, gn = clip_by_global_norm(jax.tree.map(torch.as_tensor, t), max_norm)
    want, wn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, t),
                                        max_norm)
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    _assert_trees_close(got, want)


def test_adamw_matches_jax_over_steps():
    """Five AdamW steps with fresh gradients each, decay on, from the same
    params: params and both moments to 1e-6.  The tree has no list, so
    the decay rule is the reference's rank rule on both sides."""
    rng = np.random.default_rng(1)
    p = _np_tree(rng)
    tp, jp = jax.tree.map(torch.as_tensor, p), jax.tree.map(jnp.asarray, p)
    ts, js = adamw_init(tp), jopt.adamw_init(jp)
    for i in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), p)
        lr = 1e-2 * (i + 1)
        tp, ts = adamw_update(tp, jax.tree.map(torch.as_tensor, g), ts,
                              lr=lr, weight_decay=0.1)
        jp, js = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                   lr=lr, weight_decay=0.1)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        _assert_trees_close(got, want)
    assert int(ts.step) == int(js.step) == 5


def test_compression_matches_jax():
    rng = np.random.default_rng(2)
    g, e = _np_tree(rng), _np_tree(rng)
    e = jax.tree.map(lambda a: a * 1e-3, e)
    got_g, got_e = compress_decompress(jax.tree.map(torch.as_tensor, g),
                                       jax.tree.map(torch.as_tensor, e))
    want_g, want_e = jcomp.compress_decompress(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    _assert_trees_close(got_g, want_g)
    _assert_trees_close(got_e, want_e)


def _paths(tree, prefix=""):
    """Leaf paths of a port tree, in its flatten order; list items (the
    layers) are written ``[]`` so every layer's leaf shares one name."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _paths(v, f"{prefix}[]")]
    return [prefix]


def _random_like_jax_params(arch, seed=0):
    """A tree of JAX's smoke params' structure and shapes (from
    ``jax.eval_shape``, no init run), filled with standard normal fp32."""
    model = jax_build_model(jax_get_config(arch, smoke=True))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_follows_jax_layout(arch):
    """A zero-grad AdamW step on params of JAX's smoke layout for every
    arch and on the port's copy: the same leaves decay (JAX decays every
    stacked layer leaf, norm scales included) and only the top-level norm
    scales keep their values."""
    _, jparams = _random_like_jax_params(arch)
    jparams = jax.tree.map(jnp.asarray, jparams)
    cfg = get_config(arch, smoke=True)
    tparams = _port_tree(jparams, cfg)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jnew, _ = jopt.adamw_update(jparams, zeros, jopt.adamw_init(jparams),
                                lr=0.1, weight_decay=0.5)
    tnew, _ = adamw_update(
        tparams, jax.tree.map(torch.zeros_like, tparams),
        adamw_init(tparams), lr=0.1, weight_decay=0.5)
    want = _port_tree(jnew, cfg)
    for path, a, b in zip(_paths(tnew), tree_flatten(tnew),
                          tree_flatten(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    kept = {path for path, d in zip(_paths(tparams),
                                    tree_flatten(decay_mask(tparams)))
            if not d}
    top_norms = {"/final_norm/scale"} | (
        {"/enc_norm/scale"} if cfg.kind == "encdec" else set())
    assert kept == top_norms


def _stack_like_jax(tree, cfg):
    """The port's per-layer lists stacked back into JAX's layout."""
    def stack(layers):
        return jax.tree.map(lambda *xs: np.stack([_np(x) for x in xs]),
                            *layers, is_leaf=lambda x: isinstance(
                                x, torch.Tensor))

    if cfg.kind == "encdec":
        out = {k: jax.tree.map(_np, v) for k, v in tree.items()
               if k not in ("encoder", "decoder")}
        out["encoder"] = stack(tree["encoder"])
        out["decoder"] = stack(tree["decoder"])
        return out
    out = {k: jax.tree.map(_np, v) for k, v in tree.items() if k != "blocks"}
    blocks, i = [], 0
    for period, count in cfg.segments():
        n = len(period)
        seg = [stack([tree["blocks"][i + r * n + j] for r in range(count)])
               for j in range(n)]
        blocks.append(seg)
        i += n * count
    out["blocks"] = blocks
    return out


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_train_state_from_jax_round_trip(arch):
    """A JAX ``TrainState`` of the smoke layout with distinct params,
    moments and error feedback, carried into the port and stacked back:
    every leaf bit-equal, the step equal."""
    trees = [jax.tree.map(jnp.asarray, _random_like_jax_params(arch, i)[1])
             for i in range(4)]
    state = jtrainer.TrainState(
        trees[0], jopt.AdamWState(jnp.asarray(7, jnp.int32), trees[1],
                                  trees[2]), trees[3])
    cfg = get_config(arch, smoke=True)
    ported = train_state_from_jax(state, cfg, device="cpu")
    assert ported.opt.step.dtype == torch.int32
    assert int(ported.opt.step) == int(state.opt.step) == 7
    for got, want in ((ported.params, state.params),
                      (ported.opt.m, state.opt.m),
                      (ported.opt.v, state.opt.v), (ported.ef, state.ef)):
        back = _stack_like_jax(got, cfg)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            assert a.shape == b.shape
            assert np.array_equal(a, np.asarray(b, np.float32))


# -- the port trains ----------------------------------------------------------


def _train(tcfg, steps):
    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0, tcfg)
    step = make_train_step(model, tcfg)
    it = make_batch_iterator(cfg, tcfg)
    losses = []
    for _, b in zip(range(steps), it):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    it.close()
    return state, losses


def test_training_reduces_loss():
    tcfg = TrainConfig(global_batch=8, seq_len=32, lr=5e-3, warmup_steps=5,
                       total_steps=40, microbatches=2)
    _, losses = _train(tcfg, 40)
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_grad_compression_trains():
    tcfg = TrainConfig(global_batch=8, seq_len=32, lr=5e-3, warmup_steps=5,
                       total_steps=30, grad_compression=True)
    state, losses = _train(tcfg, 30)
    assert losses[-1] < losses[0] - 0.3
    assert any(float(e.abs().max()) > 0 for e in tree_flatten(state.ef))


def test_bf16_params_keep_fp32_moments():
    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(global_batch=2, seq_len=8, param_dtype="bfloat16")
    state = init_train_state(model, 0, tcfg)
    state, m = make_train_step(model, tcfg)(state, _batch(cfg, 2, 8))
    assert all(p.dtype == torch.bfloat16 for p in tree_flatten(state.params))
    assert all(x.dtype == torch.float32
               for x in tree_flatten(state.opt.m) + tree_flatten(state.opt.v))
    assert np.isfinite(float(m["loss"]))


def test_launch_train_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` with a
    checkpoint every 2 steps, then ``--resume`` to a later step: the
    resumed run starts from the saved params (bit for bit) and the data
    stream's batch at that step."""
    argv = ["--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    state = launch_train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] step 3 loss=" in out and "tokens/s" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
    for leaf in tree_flatten(state.params):
        assert torch.isfinite(leaf).all()

    seen = {}

    def on_step(step, st, batch):
        seen.setdefault("first", (step, st.params, batch))

    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    tcfg = TrainConfig(global_batch=2, seq_len=16, lr=3e-3, warmup_steps=1,
                       total_steps=6)
    _, history = launch_train.train(cfg, tcfg, steps=6,
                                    ckpt_dir=str(tmp_path), ckpt_every=2,
                                    resume=True, log_every=1, device="cpu",
                                    on_step=on_step)
    assert "[train] resumed from step 4" in capsys.readouterr().out
    step, params, batch = seen["first"]
    assert step == 4 and [h["step"] for h in history] == [4, 5]
    for a, b in zip(tree_flatten(params), tree_flatten(state.params)):
        assert torch.equal(a, b)
    src = make_batch_iterator(cfg, tcfg, start_step=4)
    want = next(src)
    src.close()
    for k in want:
        assert want[k].tobytes() == batch[k].tobytes()
    assert launch_train.main(argv + ["--steps", "6", "--resume"]) is not None
