"""DTensor paths that the dry-run drives first, held to their unsharded
results on four gloo ranks of the CPU.

On a (data 2, model 2) mesh:

- granite-moe-1b-a400m's smoke config with its own MoE strategy,
  ``einsum`` (dispatch and combine per group shard, the experts' FFN per
  d_ff shard under ``local_map``), and with ``scatter`` (router and every
  expert per rank under ``local_map``): logits, and loss and gradients
  over two microbatches that stay sharded as the batch is;
- its prefill and decode with the cache placed by ``cache_sharding``
  (K/V written per shard, decode queries placed as the cache);
- smollm-360m's smoke config, whose 3 heads do not divide over "model":
  loss and gradients over two microbatches (the merged heads' gradient
  placed before it is split again);
- two AdamW steps with ``grad_compression=True`` (rows quantized by their
  whole row's amax where "model" splits the last dim) against two
  unsharded compressed steps: losses, params and error-feedback residuals.

On a (data 4, model 1) mesh, a batch of 8 rows in 4 microbatches: 2 rows
a microbatch over 4 data ranks, each rank's share padded to one row
(``trainer._padded_microbatches``).  granite in ``einsum`` (capacity
factor 1.0: at the smoke config's 2.0 a group's capacity is all its
tokens, and nothing ever drops) and ``sort``, and smollm: loss and
gradients against the port's unsharded step and against JAX's.  The
``einsum`` case runs on the batch in the order of the sharded
microbatches (``trainer.microbatch_rows``), since which tokens drop
depends on which rows share a group; the others on the batch as it is.
With its padding rows' tokens let into the dispatch, the ``einsum`` case
must miss the unsharded step.

On the (data 2, model 2) mesh, a batch of 2 rows in 2 microbatches: one
row a microbatch over 2 data ranks, padded, with the params split over
both axes (FSDP and tensor-parallel, ``params_sharding``), so the placed
products (``layers._dense_placed``) run their column- and row-parallel
branches.  granite in ``einsum`` and ``sort``, smollm, and granite-34b
(untied lm_head) with a vocab of 255, which "model" does not divide, so
its lm_head splits the vocab unevenly (``dense(split_out=True)``): loss
and gradients against the port's and JAX's unsharded steps.

Products run in fp32 (``layers.dense`` and ``embedding_lookup`` defaults);
logits within 1e-4 of the largest, losses within 1e-5 relative, each
gradient leaf within 1e-4 of its largest magnitude.  This file, run as a
script, is one rank (its rank half imports only ``repro_torch``).
"""
import dataclasses
import os
import sys

import numpy as np

BATCH, SEQ, PROMPT = 4, 16, 12
RANK_TIMEOUT_S = 300
GRANITE = "granite-moe-1b-a400m"
#: the padded microbatches: 8 rows in 4 microbatches over 4 data ranks
PAD_BATCH, PAD_MICRO, PAD_DP = 8, 4, 4
#: (arch, MoE strategy) of the padded cases
PAD_CASES = [(GRANITE, "einsum"), (GRANITE, "sort"), ("smollm-360m", None)]
TIGHT_CAPACITY = 1.0
#: padded microbatches with "model" split: 2 rows in 2 over 2 data ranks
PAD2_BATCH, PAD2_MICRO, PAD2_DP = 2, 2, 2
ODD_VOCAB = 255
#: (arch, MoE strategy, vocab or None for the smoke config's) on (2, 2)
PAD2_CASES = [(GRANITE, "einsum", None), (GRANITE, "sort", None),
              ("smollm-360m", None, None), ("granite-34b", None, ODD_VOCAB)]


def _smoke(arch, strategy=None, get_config=None, vocab=None):
    """The smoke config (of the package whose ``get_config`` is given),
    with ``strategy``; ``einsum`` at :data:`TIGHT_CAPACITY`; ``vocab`` if
    given."""
    cfg = get_config(arch, smoke=True)
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    if strategy is None:
        return cfg
    moe = dataclasses.replace(cfg.moe, strategy=strategy)
    if strategy == "einsum":
        moe = dataclasses.replace(moe, capacity_factor=TIGHT_CAPACITY)
    return dataclasses.replace(cfg, moe=moe)


def _pad_batch(tokens, order=None):
    if order is not None:
        tokens = tokens[order]
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


def _pad_order(b=PAD_BATCH, m=PAD_MICRO, dp=PAD_DP):
    from repro_torch.train.trainer import microbatch_rows

    return np.concatenate(microbatch_rows(b, m, dp))


def _pad2_key(arch, strategy, vocab):
    return f"pad2/{arch}/{strategy}/{vocab}"


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out: str) -> int:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model, layers, moe
    from repro_torch.sharding import (batch_sharding, cache_sharding,
                                      distribute, params_sharding, use_mesh)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.compression import compress_decompress
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainState, loss_and_grads

    layers.dense.__defaults__ = (torch.float32,)
    layers.embedding_lookup.__defaults__ = (torch.float32,)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def tree_err(got, want):
        return max(rel(b.full_tensor() if hasattr(b, "full_tensor") else b,
                       a) for a, b in zip(tree_flatten(want),
                                          tree_flatten(got)))

    def grads_vs_unsharded(key, model, tcfg, params, placed, batch, ref,
                           mesh):
        loss0, g0 = loss_and_grads(model, tcfg, params, ref)
        dbatch = distribute(batch, batch_sharding(batch, mesh))
        with use_mesh(mesh):
            loss1, g1 = loss_and_grads(model, tcfg, placed, dbatch)
        loss1 = float(loss1.full_tensor())
        res[f"{key}/loss"] = loss1
        res[f"{key}/loss_err"] = abs(loss1 - float(loss0)) / abs(float(loss0))
        res[f"{key}/grad_err"] = tree_err(g1, g0)
        return g1

    res = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rng = np.random.default_rng(0)
        for arch, strategy in ((GRANITE, None), (GRANITE, "scatter"),
                               ("smollm-360m", None)):
            # the scatter case draws its own tokens: the others keep theirs
            gen = np.random.default_rng(2) if strategy == "scatter" else rng
            cfg = get_config(arch, smoke=True)
            if strategy is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, strategy=strategy))
            key = arch if strategy is None else f"{arch}/{strategy}"
            model = build_model(cfg, device="cpu")
            params = model.init(0)
            placed = distribute(params, params_sharding(params, mesh, cfg))
            tokens = torch.as_tensor(gen.integers(0, cfg.vocab,
                                                  (BATCH, SEQ)))
            batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
            dbatch = distribute(batch, batch_sharding(batch, mesh))
            if cfg.moe is not None:
                res[f"{key}/strategy"] = np.array(cfg.moe.strategy)
                with torch.no_grad():
                    want = model.logits(params, tokens)
                    with use_mesh(mesh):
                        got = model.logits(placed,
                                           dbatch["tokens"]).full_tensor()
                res[f"{key}/logits_err"] = rel(got, want)
            tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ,
                               microbatches=2)
            grads_vs_unsharded(key, model, tcfg, params, placed, batch,
                               batch, mesh)

        # granite's prefill and decode steps on a placed cache
        cfg = get_config(GRANITE, smoke=True)
        model = build_model(cfg, device="cpu")
        params = model.init(1)
        placed = distribute(params, params_sharding(params, mesh, cfg))
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                              (BATCH, PROMPT)))
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, 1)))
        errs = []
        with torch.no_grad():
            c0 = model.init_cache(BATCH, SEQ, dtype=torch.float32)
            c1 = distribute(c0, cache_sharding(c0, mesh, cfg))
            c0 = model.init_cache(BATCH, SEQ, dtype=torch.float32)
            want, c0 = model.prefill(params, prompt, c0)
            tok = distribute({"t": prompt}, batch_sharding({"t": prompt},
                                                           mesh))["t"]
            with use_mesh(mesh):
                got, c1 = model.prefill(placed, tok, c1)
            errs.append(rel(got.full_tensor(), want))
            for _ in range(2):
                want, c0 = model.decode_step(params, c0, nxt)
                t1 = distribute({"t": nxt}, batch_sharding({"t": nxt},
                                                           mesh))["t"]
                with use_mesh(mesh):
                    got, c1 = model.decode_step(placed, c1, t1)
                errs.append(rel(got.full_tensor(), want))
        res["decode/errs"] = np.array(errs)
        res["decode/k_placements"] = np.array(
            str(c1["layers"][0]["k"].placements))

        # two compressed AdamW steps (granite, d_ff split over "model")
        tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, microbatches=2,
                           grad_compression=True, lr=1e-3, warmup_steps=0,
                           total_steps=4)
        state = init_train_state(model, 0, tcfg)
        shard = params_sharding(state.params, mesh, cfg)
        placed = distribute(state.params, shard)
        dstate = TrainState(placed, adamw_init(placed),
                            distribute(state.ef, shard))
        step = make_train_step(model, tcfg)
        losses, flipped, bad, exact = [], [], 0, True
        for i in range(2):
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                  (BATCH, SEQ)))
            batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
            # the quantizer alone, on the unsharded step's own grads
            _, g = loss_and_grads(model, tcfg, state.params, batch)
            want = compress_decompress(g, state.ef)
            got = compress_decompress(distribute(g, shard),
                                      distribute(state.ef, shard))
            exact &= all(torch.equal(b.full_tensor(), a) for a, b in zip(
                tree_flatten(want), tree_flatten(got)))
            # the compressor's input, g + e: its scale sets the tolerance
            g32 = [a.float() + e for a, e in zip(tree_flatten(g),
                                                 tree_flatten(state.ef))]
            state, m0 = step(state, batch)
            with use_mesh(mesh):
                dstate, m1 = step(dstate, distribute(
                    batch, batch_sharding(batch, mesh)))
            losses.append(abs(float(m1["loss"]) - float(m0["loss"]))
                          / abs(float(m0["loss"])))
            # each residual matches, or its element lay at a half step of
            # the quantizer in both runs, rounded to the two sides: then
            # the residuals are +-half a step (e_a = -e_b); an element that
            # flipped before carries that step into this one's input
            before = flipped or [None] * len(g32)
            flipped = []
            for ea, eb, x, was in zip(tree_flatten(dstate.ef),
                                      tree_flatten(state.ef), g32, before):
                ea, tol = ea.full_tensor(), 1e-4 * x.abs().max()
                near = (ea - eb).abs() <= tol
                flip = ~near & ((ea + eb).abs() <= tol)
                if was is not None:
                    flip |= was
                bad += int((~near & ~flip).sum())
                flipped.append(flip)
        res["compress/exact"] = np.array(exact)
        res["compress/loss_errs"] = np.array(losses)
        res["compress/ef_bad"] = bad
        res["compress/ef_flips"] = sum(int(f.sum()) for f in flipped)
        res["compress/elements"] = sum(f.numel() for f in flipped)
        # the params away from a flipped element, and the flipped ones in
        # units of the LR (AdamW moves each by about lr a step)
        p_err, p_flip = 0.0, 0.0
        for pa, pb, f in zip(tree_flatten(dstate.params),
                             tree_flatten(state.params), flipped):
            d = (pa.full_tensor() - pb).abs()
            p_err = max(p_err, float(torch.where(f, 0, d).max()
                                     / pb.abs().max()))
            p_flip = max(p_flip, float(torch.where(f, d, 0).max())
                         / tcfg.lr)
        res["compress/params_err"] = p_err
        res["compress/params_flip_lr"] = p_flip
        res["compress/ef_placements"] = np.array(
            str(dstate.ef["blocks"][0]["ffn"]["w_gate"].placements))

        # padded microbatches on (data 2, model 2): the placed products'
        # column- and row-parallel branches, and an uneven vocab split
        loaded = torch.load(inputs)
        tcfg = TrainConfig(global_batch=PAD2_BATCH, seq_len=SEQ,
                           microbatches=PAD2_MICRO)
        for arch, strategy, vocab in PAD2_CASES:
            cfg = _smoke(arch, strategy, get_config, vocab)
            key = _pad2_key(arch, strategy, vocab)
            model = build_model(cfg, device="cpu")
            params = loaded[key]
            placed = distribute(params, params_sharding(params, mesh, cfg))
            for dim, name in enumerate(("data", "model")):
                res[f"{key}/split_{name}"] = sum(
                    leaf.placements[dim].is_shard()
                    for leaf in tree_flatten(placed))
            order = (_pad_order(PAD2_BATCH, PAD2_MICRO, PAD2_DP)
                     if strategy == "einsum" else None)
            tokens = loaded["tokens2"].numpy()
            batch = {k: torch.as_tensor(v)
                     for k, v in _pad_batch(tokens).items()}
            ref = {k: torch.as_tensor(v)
                   for k, v in _pad_batch(tokens, order).items()}
            g = grads_vs_unsharded(key, model, tcfg, params, placed, batch,
                                   ref, mesh)
            for i, leaf in enumerate(tree_flatten(g)):
                res[f"{key}/g{i}"] = leaf.full_tensor().numpy()

        # microbatches whose rows do not divide the data ranks
        mesh4 = init_device_mesh("cpu", (PAD_DP, 1),
                                 mesh_dim_names=("data", "model"))
        tokens = loaded["tokens"].numpy()
        tcfg = TrainConfig(global_batch=PAD_BATCH, seq_len=SEQ,
                           microbatches=PAD_MICRO)
        for arch, strategy in PAD_CASES:
            cfg = _smoke(arch, strategy, get_config)
            key = f"pad/{arch}/{strategy}"
            model = build_model(cfg, device="cpu")
            params = loaded[arch]
            placed = distribute(params, params_sharding(params, mesh4, cfg))
            order = _pad_order() if strategy == "einsum" else None
            batch = {k: torch.as_tensor(v)
                     for k, v in _pad_batch(tokens).items()}
            ref = {k: torch.as_tensor(v)
                   for k, v in _pad_batch(tokens, order).items()}
            g = grads_vs_unsharded(key, model, tcfg, params, placed, batch,
                                   ref, mesh4)
            for i, leaf in enumerate(tree_flatten(g)):
                res[f"{key}/g{i}"] = leaf.full_tensor().numpy()
            if strategy == "einsum":
                # the padding rows' tokens let into the dispatch
                einsum = moe._moe_einsum
                moe._moe_einsum = lambda p, c, x, valid=None: einsum(p, c, x)
                try:
                    grads_vs_unsharded(f"{key}/unmasked", model, tcfg,
                                       params, placed, batch, ref, mesh4)
                finally:
                    moe._moe_einsum = einsum
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4], sys.argv[5]))


import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

from test_torch_zoo import fp32  # noqa: E402,F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]


_JAX = {}


def _jax_model(arch, strategy=None, vocab=None):
    """JAX's smoke model (:func:`_smoke`) and its params from key 0."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model

    if (arch, strategy, vocab) not in _JAX:
        model = jax_build_model(_smoke(arch, strategy, jax_get_config,
                                       vocab))
        _JAX[arch, strategy, vocab] = (model,
                                       model.init(jax.random.PRNGKey(0)))
    return _JAX[arch, strategy, vocab]


def _pad_tokens():
    return np.random.default_rng(1).integers(0, 256, (PAD_BATCH, SEQ))


def _pad2_tokens():
    return np.random.default_rng(3).integers(0, ODD_VOCAB,
                                             (PAD2_BATCH, SEQ))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch

    from test_torch_train import _port_tree

    tmp = tmp_path_factory.mktemp("mesh_paths")
    # the padded cases start from JAX's params, carried into the port
    inputs = {"tokens": torch.as_tensor(_pad_tokens()),
              "tokens2": torch.as_tensor(_pad2_tokens())}
    for arch, strategy in PAD_CASES:
        jmodel, jparams = _jax_model(arch, strategy)
        inputs[arch] = _port_tree(jparams, jmodel.cfg)
    for case in PAD2_CASES:
        jmodel, jparams = _jax_model(*case)
        inputs[_pad2_key(*case)] = _port_tree(jparams, jmodel.cfg)
    torch.save(inputs, tmp / "inputs.pt")
    world = 4
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / "store"),
         str(tmp / "inputs.pt"), str(tmp / f"rank{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def test_einsum_moe_logits_match_unsharded(ranks):
    for res in ranks:
        assert str(res[f"{GRANITE}/strategy"]) == "einsum"
        assert res[f"{GRANITE}/logits_err"] <= 1e-4


def test_scatter_moe_logits_match_unsharded(ranks):
    for res in ranks:
        assert str(res[f"{GRANITE}/scatter/strategy"]) == "scatter"
        assert res[f"{GRANITE}/scatter/logits_err"] <= 1e-4


@pytest.mark.parametrize("key", [GRANITE, f"{GRANITE}/scatter",
                                 "smollm-360m"])
def test_sharded_microbatch_grads_match_unsharded(ranks, key):
    for res in ranks:
        assert res[f"{key}/loss_err"] <= 1e-5
        assert res[f"{key}/grad_err"] <= 1e-4


def test_decode_on_a_placed_cache_matches_unsharded(ranks):
    for res in ranks:
        assert "Shard" in str(res["decode/k_placements"])
        assert res["decode/errs"].shape == (3,)
        assert res["decode/errs"].max() <= 1e-4, res["decode/errs"]


def test_compressed_steps_match_unsharded(ranks):
    """Two steps with int8 gradient compression: the quantizer on DTensor
    grads gives the unsharded one's bits; the steps' losses match the
    unsharded steps', and their error-feedback residuals and params too,
    but where a gradient element lay at a half step of the quantizer:
    the two runs' sums in another order round it to its two sides (at most
    one element in 1,000; its residuals +-half a step, and in the steps
    after, its param within two LRs a step)."""
    for res in ranks:
        assert bool(res["compress/exact"])
        assert "Shard(dim=2)" in str(res["compress/ef_placements"])
        assert res["compress/loss_errs"].max() <= 1e-5
        assert res["compress/ef_bad"] == 0
        assert res["compress/ef_flips"] <= 1e-3 * res["compress/elements"]
        assert res["compress/params_err"] <= 1e-4
        assert res["compress/params_flip_lr"] <= 4.0


@pytest.mark.parametrize("arch,strategy", PAD_CASES)
def test_padded_microbatches_match_unsharded(ranks, arch, strategy):
    for res in ranks:
        key = f"pad/{arch}/{strategy}"
        assert res[f"{key}/loss_err"] <= 1e-5
        assert res[f"{key}/grad_err"] <= 1e-4


def test_padding_that_takes_capacity_misses(ranks):
    """Teeth: with the padding rows' tokens dispatched as real ones, the
    tight-capacity ``einsum`` case misses its unsharded step."""
    for res in ranks:
        key = f"pad/{GRANITE}/einsum/unmasked"
        assert res[f"{key}/loss_err"] > 1e-5 or res[f"{key}/grad_err"] > 1e-4


def _match_jax(ranks, key, jmodel, jparams, tokens, order, m):
    """The sharded step's loss and gradients (``key``) against JAX's
    unsharded ``grads_of`` in ``m`` microbatches on the same batch (in the
    order ``order``) from the same params."""
    import jax.numpy as jnp

    from repro_torch.checkpoint.checkpointer import tree_flatten
    from test_torch_train import _port_tree
    from test_torch_train_step import _jax_loss_and_grads

    batch = {k: jnp.asarray(v) for k, v in _pad_batch(tokens, order).items()}
    jl, jg = _jax_loss_and_grads(jmodel, jparams, batch, m, True)
    want = tree_flatten(_port_tree(jg, jmodel.cfg))
    for res in ranks:
        assert abs(float(res[f"{key}/loss"]) - float(jl)) \
            <= 1e-5 * abs(float(jl))
        for i, b in enumerate(want):
            a = res[f"{key}/g{i}"]
            assert a.shape == tuple(b.shape), i
            scale = max(float(b.abs().max()), 1e-30)
            assert float(np.abs(a - b.numpy()).max()) / scale < 1e-4, i


@pytest.mark.parametrize("arch,strategy", PAD_CASES)
def test_padded_microbatches_match_jax(ranks, arch, strategy, fp32):
    """The sharded step's loss and gradients against JAX's unsharded
    ``grads_of`` on the same batch (in the sharded microbatches' order for
    ``einsum``) from the same params."""
    jmodel, jparams = _jax_model(arch, strategy)
    order = _pad_order() if strategy == "einsum" else None
    _match_jax(ranks, f"pad/{arch}/{strategy}", jmodel, jparams,
               _pad_tokens(), order, PAD_MICRO)


@pytest.mark.parametrize("arch,strategy,vocab", PAD2_CASES)
def test_padded_model_split_matches_unsharded(ranks, arch, strategy, vocab):
    """Padded microbatches with the params split over "data" and "model":
    loss and gradients against the port's unsharded step."""
    key = _pad2_key(arch, strategy, vocab)
    for res in ranks:
        assert res[f"{key}/split_data"] > 0
        assert res[f"{key}/split_model"] > 0
        assert res[f"{key}/loss_err"] <= 1e-5
        assert res[f"{key}/grad_err"] <= 1e-4


@pytest.mark.parametrize("arch,strategy,vocab", PAD2_CASES)
def test_padded_model_split_matches_jax(ranks, arch, strategy, vocab, fp32):
    """The same steps against JAX's unsharded ``grads_of``."""
    jmodel, jparams = _jax_model(arch, strategy, vocab)
    order = (_pad_order(PAD2_BATCH, PAD2_MICRO, PAD2_DP)
             if strategy == "einsum" else None)
    _match_jax(ranks, _pad2_key(arch, strategy, vocab), jmodel, jparams,
               _pad2_tokens(), order, PAD2_MICRO)


def test_recomputation_sees_the_forward_context():
    """A checkpointed body runs again in the backward with its forward's
    context variables (``gathered_params``, the current mesh).  On CUDA
    the backward runs on autograd's device thread, which does not inherit
    them: here a thread of its own runs the backward."""
    import threading

    import torch

    from repro_torch.models.decoder import checkpointed
    from repro_torch.sharding.act import gathered_params, params_gathered

    seen = []

    def body(x):
        seen.append(params_gathered())
        return torch.sin(x)

    x = torch.ones(3, requires_grad=True)
    with gathered_params():
        y = checkpointed(body, True)(x).sum()
    grads = []
    worker = threading.Thread(
        target=lambda: grads.append(torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join()
    assert seen == [True, True]
    assert torch.allclose(grads[0], torch.cos(x.detach()))
