"""granite-moe-1b-a400m as published, against its plain reference
(``bench/granite_moe_ref.py``, the benchmark's), on the CPU at the smoke
size with the published muP scalars and epsilon.

- The port's loss and every gradient leaf (MoE ``sort``, ``einsum`` and
  ``scatter``) against the reference's, with products in fp32: the two
  compute the same sums in other orders (1.3e-7 on the loss and 5.1e-7 on
  the worst leaf were read when the test was written), so 1e-5 and 1e-4
  leave two orders of magnitude for orders of summation and no room for a
  missing term.
- Prefill then decode through the cache, logits against the reference's
  full forward at every position.
- Each scalar set back alone to identity moves the loss far past that
  tolerance, so none can be dropped unseen.
- ``scales=None`` leaves every smoke model's outputs as they were, bit for
  bit: their digests (one thread) are pinned in :data:`DIGESTS`, read
  from the code before ``ModelConfig.scales`` existed.
- The reference's pinned routes and route gap, and its AdamW step against
  the program's clipping, schedule and ``adamw_update``.
"""
import dataclasses
import hashlib
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import Scales, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.train.trainer import loss_and_grads

#: the repository's root, where the benchmark's reference lives
ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import granite_moe_ref as ref  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
#: the loss's and each gradient leaf's relative error against the
#: reference, with every product in fp32 (module docstring)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture
def fp32(monkeypatch):
    """The port's ``dense`` and ``embedding_lookup`` in fp32 for the test."""
    for fn in (tlayers.dense, tlayers.embedding_lookup):
        monkeypatch.setattr(fn, "__defaults__", (torch.float32,))


def published_smoke(strategy="sort", **scales):
    """granite's smoke widths with the full config's scalars and epsilon,
    ``scales`` overriding some of them."""
    full = get_config(GRANITE)
    smoke = get_config(GRANITE, smoke=True)
    return dataclasses.replace(
        smoke, norm_eps=full.norm_eps,
        scales=dataclasses.replace(full.scales, **scales),
        moe=dataclasses.replace(smoke.moe, strategy=strategy))


def _batch(cfg, b=2, s=24, seed=3):
    return SyntheticLM(vocab=cfg.vocab, batch=b, seq_len=s,
                       seed=seed).batch_at(0)


@pytest.fixture(scope="module")
def reference():
    """(params, batch, the reference's loss and gradients) at the smoke
    size with the published scalars."""
    cfg = published_smoke()
    params = build_model(cfg, device="cpu").init(seed=1)
    batch = _batch(cfg)
    got = ref.loss_and_grads(params, batch["tokens"], batch["targets"],
                             ref.arch_of(cfg))
    return params, batch, got.loss, got.grads


def test_the_full_config_holds_the_published_values():
    cfg = get_config(GRANITE)
    assert cfg.scales == Scales(embedding=12.0, attention=0.015625,
                                residual=0.22, logits=6.0)
    assert (cfg.norm_eps, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.rope_theta,
            cfg.moe.num_experts, cfg.moe.top_k, cfg.tie_embeddings) == (
        1e-6, 24, 1024, 16, 8, 64, 512, 49155, 1e4, 32, 8, True)


@pytest.mark.parametrize("strategy", ["sort", "einsum", "scatter"])
def test_loss_and_grads_match_the_reference(fp32, reference, strategy):
    params, batch, want_loss, want = reference
    cfg = published_smoke(strategy)
    loss, grads = loss_and_grads(build_model(cfg, device="cpu"),
                                 TrainConfig(), params, batch)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    errs = ref.rel_errors(grads, want)
    worst = max(zip(errs, ref.leaf_names(want)))
    assert worst[0] <= GRAD_TOL, worst


def test_prefill_then_decode_match_the_reference_forward(fp32):
    cfg = published_smoke()
    model = build_model(cfg, device="cpu")
    params = model.init(seed=2)
    tokens = torch.as_tensor(_batch(cfg, s=20, seed=4)["tokens"]).long()
    want = ref.logits(params, tokens, ref.arch_of(cfg))
    p = 12
    cache = model.init_cache(tokens.shape[0], tokens.shape[1],
                             dtype=torch.float32)
    got, cache = model.prefill(params, tokens[:, :p], cache)
    rows = [got[:, 0]]
    for t in range(p, tokens.shape[1] - 1):
        got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        rows.append(got[:, 0])
    got = torch.stack(rows, 1).float()
    want = want[:, p - 1:tokens.shape[1] - 1]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("identity", [
    {"embedding": 1.0}, {"attention": None}, {"residual": 1.0},
    {"logits": 1.0}])
def test_each_scalar_moves_the_loss(fp32, reference, identity):
    """One scalar at identity (attention: 1/sqrt(head_dim)) moves the loss
    ten times past its tolerance (the attention scale, the least, 1.2e-4
    when the test was written) and the worst gradient leaf a thousand
    times past its own (2.5 and more)."""
    params, batch, want_loss, want = reference
    cfg = published_smoke(**identity)
    loss, grads = loss_and_grads(build_model(cfg, device="cpu"),
                                 TrainConfig(), params, batch)
    assert abs(float(loss) - want_loss) > 10 * LOSS_TOL * abs(want_loss)
    assert max(ref.rel_errors(grads, want)) > 1000 * GRAD_TOL


def test_every_config_but_granites_full_has_no_scales():
    for name in ARCH_IDS:
        for smoke in (False, True):
            cfg = get_config(name, smoke)
            assert (cfg.scales is not None) == (name == GRANITE
                                                and not smoke), name


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def smoke_outputs(name, strategy=None):
    """A smoke model's loss, logits and prefill-then-decode logits on the
    normal path (bf16 products), as one digest."""
    cfg = get_config(name, smoke=True)
    if strategy is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, strategy=strategy))
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    frames = cfg.d_model if cfg.frontend == "frames" else None
    batch = SyntheticLM(vocab=cfg.vocab, batch=2, seq_len=16, seed=0,
                        frames_dim=frames).batch_at(0)
    with torch.no_grad():
        loss, _ = model.loss(params, batch)
        if cfg.kind == "encdec":
            return _digest(loss)
        tokens = torch.as_tensor(batch["tokens"]).long()
        logits = model.logits(params, tokens)
        cache = model.init_cache(2, 16)
        first, cache = model.prefill(params, tokens[:, :12], cache)
        steps = [first]
        for t in range(12, 15):
            out, cache = model.decode_step(params, cache,
                                           tokens[:, t:t + 1])
            steps.append(out)
    return _digest(loss, logits, *steps)


#: :func:`smoke_outputs` of every smoke model (granite's under ``sort``
#: too), read with one thread from the code before ``scales``
DIGESTS = {
    "granite-moe-1b-a400m": "47d7ce2ef4e00048",
    "granite-moe-1b-a400m/sort": "6d552ab83c3c6848",
    "mixtral-8x7b": "9386cdd50df3f33a",
    "jamba-v0.1-52b": "ba78cd1fa5e308f9",
    "smollm-360m": "56122677f1a96d3e",
    "qwen2-1.5b": "b34c965d52d36404",
    "granite-34b": "c36ab38899cb2445",
    "llama3.2-3b": "289e4f36bd9c4e15",
    "rwkv6-3b": "f6d3ec313d29a9f0",
    "chameleon-34b": "d79a4d1dfab633ab",
    "seamless-m4t-large-v2": "a0a9b99b27734c2f",
}


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_no_scales_leaves_every_smoke_model_as_it_was(key):
    name, _, strategy = key.partition("/")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = smoke_outputs(name, strategy or None)
    finally:
        torch.set_num_threads(threads)
    assert got == DIGESTS[key]


def test_the_port_routes_as_the_reference(fp32, reference):
    """In fp32 the port's experts, as the benchmark's check records them,
    are the reference's own top-k in every layer."""
    from bench.drivers.lm_train import RouteRecorder

    params, batch, _, _ = reference
    cfg = published_smoke()
    with RouteRecorder() as rec:
        loss_and_grads(build_model(cfg, device="cpu"), TrainConfig(),
                       params, batch)
    got = ref.loss_and_grads(params, batch["tokens"], batch["targets"],
                             ref.arch_of(cfg))
    assert len(rec.experts) == 2 * cfg.n_layers      # forward, recomputed
    for mine, theirs in zip(rec.experts, got.routes):
        assert torch.equal(mine.sort(1).values, theirs.sort(1).values)
    assert got.route_gap == 0.0


def test_pinned_to_its_own_routes_the_reference_is_unchanged(reference):
    params, batch, want_loss, want = reference
    arch = ref.arch_of(published_smoke())
    own = ref.loss_and_grads(params, batch["tokens"], batch["targets"], arch)
    pinned = ref.loss_and_grads(params, batch["tokens"], batch["targets"],
                                arch, routes=own.routes)
    assert pinned.loss == want_loss and pinned.route_gap == 0.0
    assert max(ref.rel_errors(pinned.grads, want)) == 0.0


@pytest.mark.parametrize("down", ["next", "last"])
def test_a_route_off_the_top_k_reads_a_gap(reference, down):
    """One token of the first layer routed, in place of its last expert,
    to the next one down the ranking or to the last of all: the gap is
    that of their logits over the token's logit range, and the routes
    come back as pinned."""
    params, batch, _, _ = reference
    arch = ref.arch_of(published_smoke())
    tokens, targets = batch["tokens"], batch["targets"]
    own = ref.loss_and_grads(params, tokens, targets, arch)
    k = arch["num_experts_per_tok"]
    rank = 1 if down == "next" else arch["num_local_experts"] - k
    logits = _first_layer_router_logits(params, tokens, arch)
    order = logits[0].argsort(descending=True)
    routes = [r.clone() for r in own.routes]
    routes[0][0] = torch.cat([order[:k - 1], order[k - 1 + rank:k + rank]])
    got = ref.loss_and_grads(params, tokens, targets, arch, routes=routes)
    z = logits[0]
    want = float((z[order[k - 1]] - z[order[k - 1 + rank]])
                 / (z.max() - z.min()))
    assert got.route_gap == pytest.approx(want, rel=1e-5) and want > 0
    assert torch.equal(got.routes[0], routes[0])


def _first_layer_router_logits(params, tokens, arch):
    """The reference's first-layer router logits of the first sequence."""
    seen = []
    choose = ref._Routes.choose

    def spy(self, logits, top, at):
        if at == (0, 0):
            seen.append(logits.detach().clone())
        return choose(self, logits, top, at)

    ref._Routes.choose = spy
    try:
        ref.logits(params, torch.as_tensor(tokens[:1]), arch)
    finally:
        ref._Routes.choose = choose
    return seen[0]


def test_routes_of_another_shape_are_refused(reference):
    params, batch, _, _ = reference
    arch = ref.arch_of(published_smoke())
    own = ref.loss_and_grads(params, batch["tokens"], batch["targets"], arch)
    with pytest.raises(ValueError, match="routes"):
        ref.loss_and_grads(params, batch["tokens"], batch["targets"], arch,
                           routes=[r[:, 1:] for r in own.routes])


@pytest.mark.parametrize("step", [3, 150, 2000])
def test_the_reference_adamw_step_is_the_programs(step):
    """The reference's AdamW step (float64) against the program's
    clipping, schedule and ``adamw_update`` (float32) on granite's smoke
    tree, in warm-up, in the cosine and past its end: each leaf's change
    within float32 rounding of the reference's (7.0e-5 at step 3, where
    the change is least against the parameters' own rounding, and 6e-6
    after, when the test was written)."""
    from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                             clip_by_global_norm,
                                             cosine_schedule)

    cfg = published_smoke()
    params = build_model(cfg, device="cpu").init(seed=5)
    gen = torch.Generator().manual_seed(step)

    def like(scale, positive=False):
        def draw(p):
            t = torch.randn(p.shape, generator=gen) * scale
            return t.abs() if positive else t
        return tree_map(draw, params)

    grads, m, v = like(0.3), like(1e-3), like(1e-4, positive=True)
    hp = {"lr": 3e-4, "warmup_steps": 100, "total_steps": 1000,
          "final_lr_frac": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
          "weight_decay": 0.1, "grad_clip": 1.0}
    want = ref.adamw_step(params, grads, m, v, step, hp)
    clipped, _ = clip_by_global_norm(grads, hp["grad_clip"])
    at = torch.tensor(step, dtype=torch.int32)
    lr = cosine_schedule(at, base_lr=hp["lr"], warmup=hp["warmup_steps"],
                         total=hp["total_steps"])
    got, _ = adamw_update(params, clipped, AdamWState(at, m, v), lr=lr,
                          weight_decay=hp["weight_decay"])

    def moved(new):
        return [a.double() - b.double() for a, b in
                zip(ref._leaves(new), ref._leaves(params))]

    errs = ref.rel_errors(moved(got), moved(want))
    assert max(errs) <= 3e-4, max(zip(errs, ref.leaf_names(params)))
    # a no-op reads 1
    assert min(ref.rel_errors(moved(params), moved(want))) == 1.0

