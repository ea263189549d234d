"""``repro_torch.launch.dryrun``: the counting mode on small DTensor ops,
and granite-moe-1b-a400m's cells against ``repro.launch.dryrun``.

- A sharded matmul counts the rank's local FLOPs, not the global ones that
  ``FlopCounterMode`` sees on a DTensor, with DTensor's sharding cache
  cold (its propagation probe runs the op at global shapes on fake
  tensors) or warm; a redistribute counts one all-gather of its result's
  bytes.
- On a (1, 1) mesh a model's counts equal its counts with no mesh.
- A cell counted in one run equals the same cell counted after a warm-up
  run (``count_cell(..., warm=True)``).
- granite's ``argument_bytes`` on the single-pod mesh equal the reference
  dry-run's, for all four shapes: the reference runs in a subprocess with
  ``JAX_PLATFORMS=cpu`` (its import asks for 512 virtual devices; this
  session has 8).  At the published depth the bytes of the arguments the
  step reads are computed without running the step for all four shapes,
  and ``run_cell``'s field is compared for decode_32k and long_500k; at
  two layers (both packages) ``run_cell``'s field for all four.
- Replaying repeated calls counts what running them counts.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import distribute, params_sharding, use_mesh

ROOT = Path(__file__).resolve().parents[1]
GRANITE = "granite-moe-1b-a400m"


def _cold_sharding_cache():
    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator \
        .propagate_op_sharding.cache_clear()


def _sharded_operands(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = DTensor.from_local(torch.empty((64, 128), device="meta"), mesh,
                           [Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty((128, 64), device="meta"), mesh,
                           [Shard(1)], run_check=False, shape=(128, 256),
                           stride=(256, 1))
    return x, w


def test_local_flops_of_a_sharded_matmul():
    """x (64, 128) replicated @ w (128, 256) sharded on its columns over 4
    ranks: each rank multiplies by its (128, 64) shard."""
    from torch.utils.flop_counter import FlopCounterMode

    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (4,))
        x, w = _sharded_operands(mesh)
        _cold_sharding_cache()
        counts = []
        for _ in range(2):                    # cache cold, then warm
            mode = dryrun.CostMode()
            with mode:
                out = x @ w
            counts.append(mode.flops)
        assert counts == [2 * 64 * 128 * 64] * 2 == [1048576] * 2
        assert tuple(out.to_local().shape) == (64, 64)
        with FlopCounterMode(display=False) as fc:
            x @ w
        assert fc.get_total_flops() == 4194304       # the global count


def test_collective_counts_of_a_redistribute():
    from torch.distributed.tensor import Replicate

    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (4,))
        _, w = _sharded_operands(mesh)
        mode = dryrun.CostMode()
        with mode:
            w.redistribute(mesh, [Replicate()])
        assert mode.collectives["all-gather"] == {"count": 1,
                                                  "bytes": 128 * 256 * 4}
        assert all(v["count"] == 0 for k, v in mode.collectives.items()
                   if k != "all-gather")


def _loss_counts(cfg, params, batch):
    mode = dryrun.CostMode()
    with mode, torch.no_grad():
        build_model(cfg, device="meta").loss(params, batch)
    return mode


@pytest.mark.parametrize("arch", [GRANITE, "llama3.2-3b"])
def test_one_by_one_mesh_counts_equal_no_mesh(arch):
    cfg = get_config(arch, smoke=True)
    params = specs.meta_model_init(cfg, lambda m: m.init(0))
    batch = {k: torch.empty((2, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    plain = _loss_counts(cfg, params, batch)
    with dryrun.fake_world(1):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        placed = distribute(params, params_sharding(params, mesh, cfg))
        with use_mesh(mesh):
            meshed = _loss_counts(cfg, placed, batch)
    assert meshed.flops == plain.flops > 0
    assert meshed.transcendentals == plain.transcendentals > 0
    assert dict(meshed.flops_by_op) == dict(plain.flops_by_op)


def test_one_run_counts_what_a_warm_run_counts(monkeypatch):
    """granite's decode_32k at one layer on the 256-rank mesh: counted with
    DTensor's sharding cache cold, and after a warm-up run."""
    published = specs.get_config
    monkeypatch.setattr(specs, "get_config", lambda a: dataclasses.replace(
        published(a), n_layers=1))
    got = []
    for warm in (False, True):
        with dryrun.fake_world(256):
            mesh = make_production_mesh(device_type="cpu")
            cell = specs.build_cell(GRANITE, "decode_32k", mesh)
            _cold_sharding_cache()
            mode, _, _ = dryrun.count_cell(cell, mesh, warm=warm)
        got.append((mode.flops, mode.transcendentals, mode.bytes_accessed,
                    mode.collectives, mode.peak_bytes))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][3]["all-gather"]["count"] > 0


def test_run_cell_decode_record():
    r = dryrun.run_cell(GRANITE, "decode_32k", multi_pod=False,
                        verbose=False)
    assert r["status"] == "ok" and r["devices"] == 256
    mem = r["memory"]
    assert mem["peak_bytes_per_device"] == mem["argument_bytes"] \
        + mem["temp_bytes"]
    assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
    assert set(r["collectives"]) == set(dryrun.COLLECTIVES)
    assert r["collective_bytes_total"] == sum(
        v["bytes"] for v in r["collectives"].values())
    assert r["cost"]["flops"] > 0 and r["cost"]["transcendentals"] > 0


def test_skipped_cell():
    r = dryrun.run_cell("seamless-m4t-large-v2", "long_500k",
                        multi_pod=False)
    assert r["status"] == "skipped" and "500k" in r["reason"]


def _port_argument_bytes(shape):
    """The bytes rank 0 holds of the arguments the step reads, without
    running the step: every argument but the prefill's old cache
    position, which its prefill never reads (jit drops it)."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        cell = specs.build_cell(GRANITE, shape, mesh)
        args = tuple(distribute(a, s)
                     for a, s in zip(cell.args, cell.in_shardings))
        unread = args[2]["pos"] if shape.startswith("prefill") else None
        return dryrun.local_bytes(args) - (dryrun.local_bytes(unread)
                                           if unread is not None else 0)


#: granite's depth in the two-layer checks, on both sides
LAYERS = 2
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(scope="module")
def jax_argument_bytes():
    """The reference dry-run's ``argument_bytes`` of granite's four cells,
    at the published depth and at :data:`LAYERS` layers."""
    code = f"""
import dataclasses, json
import repro.configs
from repro.launch.dryrun import run_cell
def arg_bytes():
    return {{s: run_cell({GRANITE!r}, s, multi_pod=False, verbose=False)
            ["memory"]["argument_bytes"] for s in {SHAPE_NAMES!r}}}
full = arg_bytes()
published = repro.configs.get_config
repro.configs.get_config = lambda a, **kw: dataclasses.replace(
    published(a, **kw), n_layers={LAYERS})
print(json.dumps({{"full": full, "layers": arg_bytes()}}))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_argument_bytes_match_reference(shape, jax_argument_bytes):
    assert _port_argument_bytes(shape) == jax_argument_bytes["full"][shape]


def test_run_cell_argument_bytes_count_what_the_step_reads(
        jax_argument_bytes):
    for shape in ("decode_32k", "long_500k"):
        r = dryrun.run_cell(GRANITE, shape, multi_pod=False, verbose=False)
        assert r["memory"]["argument_bytes"] \
            == jax_argument_bytes["full"][shape]


def _layers(monkeypatch, n=LAYERS):
    published = specs.get_config
    monkeypatch.setattr(specs, "get_config", lambda a: dataclasses.replace(
        published(a), n_layers=n))


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_run_cell_argument_bytes_at_two_layers(shape, jax_argument_bytes,
                                                monkeypatch):
    """The field ``run_cell`` writes, on all four shapes, against the
    reference dry-run of the same two-layer granite: the published depth
    takes 90 s (train_4k) on a CPU, the other shapes are held there by the
    test above."""
    _layers(monkeypatch)
    r = dryrun.run_cell(GRANITE, shape, multi_pod=False, verbose=False)
    assert r["memory"]["argument_bytes"] \
        == jax_argument_bytes["layers"][shape]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_replayed_calls_count_what_running_them_counts(shape, monkeypatch):
    """:class:`CostMode` replays repeated pure meta calls; with the replay
    off, every count and byte of a two-layer granite cell is the same."""
    _layers(monkeypatch)
    got = []
    for replay in (True, False):
        if not replay:
            monkeypatch.setattr(dryrun.CostMode, "_memo_key",
                                staticmethod(lambda *a: None))
        r = dryrun.run_cell(GRANITE, shape, multi_pod=False, verbose=False)
        got.append({k: r[k] for k in ("memory", "cost", "flops_by_op",
                                      "collectives")})
    assert got[0] == got[1]


def _train_counts(cfg, b, m, s, dp=None, tp=1):
    """Rank 0's counts of one ``loss_and_grads`` of ``b`` rows of ``s``
    tokens in ``m`` microbatches, on meta tensors: unsharded, or on a
    (data ``dp``, model ``tp``) mesh of a fake group."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.sharding import batch_sharding
    from repro_torch.train.trainer import loss_and_grads

    model = build_model(cfg, device="meta")
    params = specs.meta_model_init(cfg, lambda mdl: mdl.init(0))
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    tcfg = TrainConfig(global_batch=b, seq_len=s, microbatches=m)
    mode = dryrun.CostMode()
    if dp is None:
        with mode:
            loss_and_grads(model, tcfg, params, batch)
        return mode
    with dryrun.fake_world(dp * tp):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (dp, tp),
                                mesh_dim_names=("data", "model"))
        placed = distribute(params, params_sharding(params, mesh, cfg))
        dbatch = distribute(batch, batch_sharding(batch, mesh))
        with use_mesh(mesh), mode:
            loss_and_grads(model, tcfg, placed, dbatch)
    return mode


@pytest.mark.parametrize("arch", [GRANITE, "smollm-360m"])
def test_padded_microbatches_count_their_rows(arch):
    """8 rows of 4096 tokens in 4 microbatches over 4 data ranks: each rank
    computes one padded row a microbatch, ``ceil(b/m/dp) * m / b`` = 1/2
    of the unsharded step's products (plus 5%), not the 2 rows of each
    microbatch that a slice of the global rows puts on every rank.  At
    4096 tokens a row is one ``einsum`` MoE group (at fewer, one group
    holds the microbatch, and its dispatch runs whole on every rank)."""
    cfg = get_config(arch, smoke=True)
    b, m, dp, s = 8, 4, 4, 4096
    full = _train_counts(cfg, b, m, s).flops
    sharded = _train_counts(cfg, b, m, s, dp=dp).flops
    share = -(-(b // m) // dp) * m / b
    assert 0 < sharded <= share * full * 1.05, (sharded, full)


def test_uneven_vocab_split_counts_its_chunk(monkeypatch):
    """A padded microbatch's lm_head over a vocab that "model" does not
    divide (seamless's 256,206 over 16) computes rank 0's chunk of it,
    ``ceil(V/tp)`` columns, in its forward, ``dx`` and ``dw`` products: the
    count falls by ``6 * tokens * d * (V - ceil(V/tp))`` against the same
    step with the vocab whole on every model rank."""
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("granite-34b", smoke=True),
                              vocab=4099)
    b, m, dp, tp, s = 2, 2, 2, 4, 256
    split = _train_counts(cfg, b, m, s, dp=dp, tp=tp).flops
    placed = layers._dense_placed
    monkeypatch.setattr(layers, "_dense_placed",
                        lambda x, w, dt, split_out=False: placed(x, w, dt))
    whole = _train_counts(cfg, b, m, s, dp=dp, tp=tp).flops
    tokens = -(-(b // m) // dp) * m * s
    chunk = -(-cfg.vocab // tp)
    want = 6 * tokens * cfg.d_model * (cfg.vocab - chunk)
    assert abs((whole - split) - want) <= 0.01 * want, (whole, split, want)


def test_jamba_train_cell_with_padded_microbatches(monkeypatch):
    """jamba's smoke config on the 256-rank mesh, train_4k's 256 rows (at
    128 tokens) in 32 microbatches: 16 local rows do not divide into 32,
    and the cell runs (a microbatch's 8 rows on every rank could not
    unflatten its mamba tokens sharded over 16 ranks)."""
    from repro_torch.configs.base import ShapeSpec

    monkeypatch.setattr(specs, "get_config",
                        lambda a: get_config(a, smoke=True))
    monkeypatch.setitem(specs.SHAPES, "train_4k",
                        ShapeSpec("train_4k", 128, 256, "train"))
    r = dryrun.run_cell("jamba-v0.1-52b", "train_4k", multi_pod=False,
                        microbatches=32, verbose=False)
    assert r["status"] == "ok" and r["microbatches"] == 32
    assert r["cost"]["flops"] > 0
