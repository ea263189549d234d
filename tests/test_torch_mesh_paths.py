"""DTensor paths that the dry-run drives first, held to their unsharded
results on four gloo ranks of the CPU (a (data 2, model 2) mesh):

- granite-moe-1b-a400m's smoke config with its own MoE strategy,
  ``einsum`` (dispatch and combine per group shard, the experts' FFN per
  d_ff shard under ``local_map``): logits, and loss and gradients over two
  microbatches that stay sharded as the batch is;
- its prefill and decode with the cache placed by ``cache_sharding``
  (K/V written per shard, decode queries placed as the cache);
- smollm-360m's smoke config, whose 3 heads do not divide over "model":
  loss and gradients over two microbatches (the merged heads' gradient
  placed before it is split again).

Products run in fp32 (``layers.dense`` and ``embedding_lookup`` defaults);
logits within 1e-4 of the largest, losses within 1e-5 relative, each
gradient leaf within 1e-4 of its largest magnitude.  This file, run as a
script, is one rank (it imports only ``repro_torch``).
"""
import os
import sys

import numpy as np

BATCH, SEQ, PROMPT = 4, 16, 12
RANK_TIMEOUT_S = 300


def _rank_main(rank: int, world: int, store: str, out: str) -> int:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model, layers
    from repro_torch.sharding import (batch_sharding, cache_sharding,
                                      distribute, params_sharding, use_mesh)
    from repro_torch.train.trainer import loss_and_grads

    layers.dense.__defaults__ = (torch.float32,)
    layers.embedding_lookup.__defaults__ = (torch.float32,)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rng = np.random.default_rng(0)
        for arch in ("granite-moe-1b-a400m", "smollm-360m"):
            cfg = get_config(arch, smoke=True)
            model = build_model(cfg, device="cpu")
            params = model.init(0)
            placed = distribute(params, params_sharding(params, mesh, cfg))
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                  (BATCH, SEQ)))
            batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
            dbatch = distribute(batch, batch_sharding(batch, mesh))
            if cfg.moe is not None:
                res[f"{arch}/strategy"] = np.array(cfg.moe.strategy)
                with torch.no_grad():
                    want = model.logits(params, tokens)
                    with use_mesh(mesh):
                        got = model.logits(placed,
                                           dbatch["tokens"]).full_tensor()
                res[f"{arch}/logits_err"] = float(
                    (got - want).abs().max() / want.abs().max())
            tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ,
                               microbatches=2)
            loss0, g0 = loss_and_grads(model, tcfg, params, batch)
            with use_mesh(mesh):
                loss1, g1 = loss_and_grads(model, tcfg, placed, dbatch)
            res[f"{arch}/loss_err"] = float(
                abs(float(loss1.full_tensor()) - float(loss0))
                / abs(float(loss0)))
            res[f"{arch}/grad_err"] = max(
                float((b.full_tensor() - a).abs().max()
                      / a.abs().max().clamp_min(1e-30))
                for a, b in zip(tree_flatten(g0), tree_flatten(g1)))

        # granite's prefill and decode steps on a placed cache
        cfg = get_config("granite-moe-1b-a400m", smoke=True)
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
            errs.append((got.full_tensor() - want).abs().max()
                        / want.abs().max())
            for _ in range(2):
                want, c0 = model.decode_step(params, c0, nxt)
                t1 = distribute({"t": nxt}, batch_sharding({"t": nxt},
                                                           mesh))["t"]
                with use_mesh(mesh):
                    got, c1 = model.decode_step(placed, c1, t1)
                errs.append((got.full_tensor() - want).abs().max()
                            / want.abs().max())
        res["decode/errs"] = np.array([float(e) for e in errs])
        res["decode/k_placements"] = np.array(
            str(c1["layers"][0]["k"].placements))
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4]))


import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_paths")
    world = 4
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / "store"),
         str(tmp / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
        assert str(res["granite-moe-1b-a400m/strategy"]) == "einsum"
        assert res["granite-moe-1b-a400m/logits_err"] <= 1e-4


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "smollm-360m"])
def test_sharded_microbatch_grads_match_unsharded(ranks, arch):
    for res in ranks:
        assert res[f"{arch}/loss_err"] <= 1e-5
        assert res[f"{arch}/grad_err"] <= 1e-4


def test_decode_on_a_placed_cache_matches_unsharded(ranks):
    for res in ranks:
        assert "Shard" in str(res["decode/k_placements"])
        assert res["decode/errs"].shape == (3,)
        assert res["decode/errs"].max() <= 1e-4, res["decode/errs"]
