"""The port's distribution layer (``repro_torch.dist``) against the JAX
package's ``repro.dist``, case for case with ``tests/test_dist.py``.

Phase 1 is byte-equal: tiles, ``padded_grid``, axis, shard count,
``shard_ok``, ``ici_bytes`` and every shard plan's layouts, (padded) index
plans and, on the ``cuda`` backend, ``StreamSchedule``\\ s against the JAX
``pallas`` backend's.  Phase 2 (the kernels' plain versions on the CPU) is
held to the JAX ``reference`` backend's sharded apply and to ``a @ b``
with ``rtol = atol = 1e-4``.  The JAX side runs on the 8 virtual CPU
devices of ``tests/conftest.py``; the port's serial path on a
single-process mesh (``make_virtual_mesh(n, "cpu")``).

The collective path runs in 2 and 4 gloo ranks: this file, run as a
script, is one rank (it imports only ``repro_torch``); a module fixture
spawns the ranks once per world size, each runs every case on a 1-D
``DeviceMesh`` and writes its results, and the tests hold them to the
serial path and to JAX.

``tests/test_dist.py::test_jit_apply_and_pytree_roundtrip`` has no
counterpart: the port's plans are frozen host objects, not pytrees, and
PyTorch has no ``jit`` that this path needs.
"""
import os
import sys

import numpy as np

#: the collective cases every rank runs: (name, dataflow); "ffn" is
#: ``sparse_ffn_apply`` of a sharded ``compress_ffn`` at 4 tokens, and
#: "autotune" the plan that autotune picks, measuring on every rank
RANK_CASES = (("ip_m", "ip_m"), ("op_m", "op_m"), ("gust_m", "gust_m"),
              ("ffn", None), ("autotune", "auto"))
#: budgeted cases every rank runs under RANK_BUDGET (bytes of L1, L2),
#: with device=None: some shards tile, and mixed shards hold their own
#: dataflows; they take the collective path all the same
BUDGET_CASES = ("ip_m", "op_m", "mixed")
RANK_BUDGET = (1 << 10, 2 << 10)
#: more shards than ranks: the serial path, on every rank
OVER_SHARDS = 8
#: ragged operands (5 tokens at block 8) every rank runs: a row band
#: wholly in the grid's padding, a k-slab that ends inside a block
RAGGED_CASES = ("gust_m", "op_m")
RAGGED = dict(seed=7, m=5, k=44, n=37, da=0.6, db=0.5)
BS = (8, 8, 8)
FFN_D, FFN_F, FFN_BLOCK, FFN_TOKENS = 16, 32, 8, 4


def _case(seed=0, m=32, k=48, n=40, da=0.4, db=0.5):
    from repro_torch.core.formats import random_sparse_dense

    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


def _ffn_case(seed=0):
    """Masked FFN weights, their parameter tree and a 4-token input."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((FFN_D // FFN_BLOCK, FFN_F // FFN_BLOCK)) < 0.6
            ).astype(np.float32)
    w = {name: rng.standard_normal(shape).astype(np.float32)
         for name, shape in (("w_gate", (FFN_D, FFN_F)),
                             ("w_up", (FFN_D, FFN_F)),
                             ("w_down", (FFN_F, FFN_D)))}
    x = rng.standard_normal((1, FFN_TOKENS, FFN_D)).astype(np.float32)
    params = {k: {"w": v} for k, v in w.items()}
    params["block_mask"] = mask
    return params, x


def _ffn_reference(params, x):
    full = np.kron(params["block_mask"], np.ones((FFN_BLOCK,) * 2))
    x2 = x.reshape(-1, FFN_D).astype(np.float64)
    g = x2 @ (params["w_gate"]["w"] * full)
    u = x2 @ (params["w_up"]["w"] * full)
    return ((g / (1.0 + np.exp(-g))) * u) @ (params["w_down"]["w"] * full.T)


def _rank_main(rank: int, world: int, store: str, out: str) -> int:
    """One gloo rank: every case of RANK_CASES on a 1-D DeviceMesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    os.environ["REPRO_VERIFY"] = "0"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
        from repro_torch import (DistPartition, MemoryBudget, PlanCache,
                                 TiledPlan, compress_ffn, flexagon_plan, obs,
                                 sparse_ffn_apply)
        from repro_torch.backends.policies import AutotunePolicy
        from repro_torch.launch.mesh import make_virtual_mesh

        reg = obs.get_registry()
        a, b = _case()
        res = {}
        for name, dataflow in RANK_CASES:
            before = reg.value("dist.collectives")
            if dataflow is None:
                params, x = _ffn_case()
                comp = compress_ffn(params, tokens=FFN_TOKENS,
                                    block=FFN_BLOCK, backend="cuda",
                                    device="cpu", mesh=mesh)
                entry = comp.specialize(FFN_TOKENS)
                paths = {entry.plan_in.path, entry.plan_out.path}
                got = sparse_ffn_apply(comp, torch.as_tensor(x))
            else:
                plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                                     backend="cuda", device="cpu",
                                     mesh=mesh, policy=AutotunePolicy(reps=1)
                                     if dataflow == "auto" else None)
                before = reg.value("dist.collectives")
                paths = {plan.path}
                got = plan.apply(a, b)
                res[f"{name}/dataflow"] = np.asarray(plan.dataflow)
            res[f"{name}/out"] = got.numpy()
            res[f"{name}/collective"] = np.asarray(paths == {"collective"})
            res[f"{name}/collectives"] = np.asarray(
                reg.value("dist.collectives") - before)
        for dataflow in BUDGET_CASES:
            # device=None on a cpu DeviceMesh: the plan goes to the CPU
            plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                                 backend="cuda", mesh=mesh,
                                 memory_budget=MemoryBudget(*RANK_BUDGET))
            before = reg.value("dist.collectives")
            name = f"budget_{dataflow}"
            res[f"{name}/out"] = plan.apply(a, b).numpy()
            res[f"{name}/collective"] = np.asarray(plan.path == "collective")
            res[f"{name}/collectives"] = np.asarray(
                reg.value("dist.collectives") - before)
            res[f"{name}/tiled"] = np.asarray(
                any(isinstance(p, TiledPlan) for p in plan.plans))
            res[f"{name}/device"] = np.asarray(str(plan.device))
        ra, rb = _case(**RAGGED)
        for dataflow in RAGGED_CASES:
            plan = flexagon_plan(ra, rb, dataflow=dataflow, block_shape=BS,
                                 backend="cuda", device="cpu", mesh=mesh)
            before = reg.value("dist.collectives")
            name = f"ragged_{dataflow}"
            res[f"{name}/out"] = plan.apply(ra, rb).numpy()
            res[f"{name}/collective"] = np.asarray(plan.path == "collective")
            res[f"{name}/collectives"] = np.asarray(
                reg.value("dist.collectives") - before)
        plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                             backend="cuda", device="cpu", mesh=mesh,
                             partition=DistPartition(shards=OVER_SHARDS))
        before = reg.value("dist.collectives")
        res["over/out"] = plan.apply(a, b).numpy()
        res["over/serial"] = np.asarray(plan.path == "serial")
        res["over/collectives"] = np.asarray(
            reg.value("dist.collectives") - before)
        # one cache and one autotune policy, a single-process mesh and a
        # DeviceMesh of the same shape: never each other's plan or pick
        cache, pol = PlanCache(), AutotunePolicy(reps=1)
        virtual = make_virtual_mesh(world, "cpu")
        got = [cache.get(a, b, dataflow=dataflow, block_shape=BS,
                         backend="cuda", device="cpu", mesh=m, policy=pol)
               for dataflow in ("ip_m", "auto") for m in (virtual, mesh)]
        res["cache/paths"] = np.asarray([p.path for p in got])
        res["cache/builds"] = np.asarray(cache.builds)
        res["cache/measurements"] = np.asarray(pol.measurements)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4]))


import dataclasses  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import MemoryBudget as JaxBudget  # noqa: E402
from repro import flexagon_plan as jax_flexagon_plan  # noqa: E402
from repro import get_backend as jax_get_backend  # noqa: E402
from repro import dist as jax_dist  # noqa: E402
from repro import memory as jax_memory  # noqa: E402
from repro.core.formats import block_occupancy  # noqa: E402
from repro.core.selector import LayerShape as JaxLayerShape  # noqa: E402
from repro.launch.mesh import make_virtual_mesh as jax_mesh  # noqa: E402

from repro_torch import (DistPartition, FlexagonPlan, MemoryBudget,  # noqa: E402
                         PlanCache, ShardedPlan, SparseOperand, TiledPlan,
                         compress_ffn, flexagon_plan, get_backend, obs,
                         sparse_ffn_apply)
from repro_torch.core.dataflows import DATAFLOWS  # noqa: E402
from repro_torch.core.selector import LayerShape  # noqa: E402
from repro_torch.dist import Partitioner, default_axis, mesh_key  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_local_mesh,  # noqa: E402
                                     make_virtual_mesh, mesh_placement)
from repro_torch.memory import sharded_estimate, sharded_traffic  # noqa: E402
from repro_torch.memory.tiling import Tile  # noqa: E402
from repro_torch.obs.trace import _reset_override  # noqa: E402
from test_torch_memory import (TPU_NUMBERS, _same_sub_plan,  # noqa: E402
                               _same_tiled_plan)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
#: each gloo rank's limit: a hung rendezvous fails its test, not the suite
RANK_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _no_verify(monkeypatch):
    # the port has no plan verifier yet (ROADMAP item 10): verify=True and
    # REPRO_VERIFY=1 raise, so these tests plan with verification off
    monkeypatch.setenv("REPRO_VERIFY", "0")


@pytest.fixture(scope="module")
def ab():
    return _case()


def _mesh(shards):
    return make_virtual_mesh(shards, "cpu")


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX ``reference`` sharded applies of ``_case()``, built once per
    (dataflow, shards): each runs a ``shard_map`` that takes seconds."""
    cache = {}

    def get(dataflow, shards):
        key = (dataflow, shards)
        if key not in cache:
            a, b = _case()
            plan = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                                     mesh=jax_mesh(shards))
            cache[key] = np.asarray(plan.apply(a, b))
        return cache[key]
    return get


def _same_sharded_plan(tp, jp):
    """Phase 1 byte-equal: the sharded plan and every shard plan."""
    assert isinstance(tp, ShardedPlan) and isinstance(jp, jax_dist.ShardedPlan)
    assert (tp.dataflow, tp.axis, tp.n_shards, tp.shard_ok, tp.collective,
            tp.fingerprint) == (jp.dataflow, jp.axis, jp.n_shards,
                                jp.shard_ok, jp.collective, jp.fingerprint)
    assert tp.padded_grid == tuple(jp.padded_grid)
    assert tp.shapes == tuple(jp.shapes)
    assert tp.ici_bytes == jp.ici_bytes
    assert tp.dist_stats == jp.dist_stats
    assert [dataclasses.astuple(t) for t in tp.tiles] == \
        [dataclasses.astuple(t) for t in jp.tiles]
    assert np.array_equal(tp.occ_a, jp.occ_a)
    assert np.array_equal(tp.occ_b, jp.occ_b)
    assert len(tp.plans) == len(jp.plans)
    for t_sub, j_sub in zip(tp.plans, jp.plans):
        if isinstance(t_sub, TiledPlan):
            _same_tiled_plan(t_sub, j_sub)
        else:
            _same_sub_plan(t_sub, j_sub)


def _plans(a, b, shards, backend="cuda", fmt=None, budget=None, **kw):
    """(port plan, JAX plan) for the same arguments on ``shards``-shard
    meshes; ``cuda`` is held to the JAX ``pallas`` backend."""
    a_in = a if fmt is None else SparseOperand.from_dense(
        a, fmt, BS[:2], device="cpu")
    tp = flexagon_plan(a_in, b, block_shape=BS, backend=backend,
                       mesh=_mesh(shards), spec=TPU_NUMBERS,
                       memory_budget=None if budget is None
                       else MemoryBudget(*budget), **kw)
    jp = jax_flexagon_plan(a, b, block_shape=BS,
                           backend="pallas" if backend == "cuda" else backend,
                           mesh=jax_mesh(shards),
                           memory_budget=None if budget is None
                           else JaxBudget(*budget), **kw)
    return tp, jp


# ---------------------------------------------------------------------------
# sharded-vs-single-device parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("fmt", ["bcsr", "bcsc"])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_sharded_parity(dataflow, fmt, shards, ab, jax_outputs):
    a, b = ab
    tp, jp = _plans(a, b, shards, fmt=fmt, dataflow=dataflow)
    if shards > 1:
        _same_sharded_plan(tp, jp)
        assert tp.n_shards == shards and tp.axis == default_axis(dataflow)
        assert tp.shard_ok and tp.path == "serial"
    else:
        assert isinstance(tp, FlexagonPlan)   # 1 shard degrades gracefully
        _same_sub_plan(tp, jp)
    a_op = SparseOperand.from_dense(a, fmt, BS[:2], device="cpu")
    b_op = SparseOperand.from_dense(b, fmt, BS[1:], device="cpu")
    out = tp.apply(a_op, b_op).numpy()
    np.testing.assert_allclose(out, jax_outputs(dataflow, shards), **TOL)
    np.testing.assert_allclose(out, a @ b, **TOL)
    single = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                           backend="cuda", device="cpu")
    np.testing.assert_allclose(out, single.apply(a, b).numpy(), **TOL)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_ragged_shapes_shard_at_their_real_extent(dataflow, shards,
                                                  backend):
    """Operands that end inside a block (5 tokens at block 8) and grids
    that the shards do not divide: each shard runs on its real extent,
    the result equals the unsharded plan (bit for bit for disjoint
    partitions) and ``a @ b``; phase 1 is still JAX's."""
    a, b = _case(seed=7, m=5, k=44, n=37, da=0.6, db=0.5)
    tp, jp = _plans(a, b, shards, backend=backend, dataflow=dataflow)
    _same_sharded_plan(tp, jp)
    out = tp.apply(a, b).numpy()
    assert out.shape == (5, 37)
    single = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                           backend=backend, device="cpu")
    want = single.apply(a, b).numpy()
    np.testing.assert_allclose(out, a @ b, **TOL)
    if tp.axis == "k":
        np.testing.assert_allclose(out, want, **TOL)
    else:
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_reference_backend_plans_equal(dataflow, ab):
    a, b = ab
    tp, jp = _plans(a, b, 4, backend="reference", dataflow=dataflow)
    _same_sharded_plan(tp, jp)
    np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b, **TOL)


def test_sharded_parity_vs_tiled_single_device(ab):
    """Sharded apply == single-device TiledPlan result, and phase 1 equal
    to JAX's with tiling inside the shards."""
    a, b = ab
    budget = (1 << 10, 2 << 10)
    tiled_some = False
    for dataflow in ("ip_m", "op_m", "gust_m"):
        tiled = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                              device="cpu",
                              memory_budget=MemoryBudget(*budget))
        tiled_some |= isinstance(tiled, TiledPlan)
        tp, jp = _plans(a, b, 8, dataflow=dataflow, budget=budget)
        _same_sharded_plan(tp, jp)
        np.testing.assert_allclose(tp.apply(a, b).numpy(),
                                   tiled.apply(a, b).numpy(), **TOL)
    assert tiled_some    # the budget is small enough to tile at least one


def test_mixed_sharded_plans_equal(ab):
    a, b = ab
    tp, jp = _plans(a, b, 2, dataflow="mixed", budget=(1 << 10, 2 << 10))
    _same_sharded_plan(tp, jp)
    assert not tp.shard_ok and tp.out_major == "csr"
    np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b, **TOL)


def test_path_follows_the_mesh_not_the_backend(ab):
    """Any backend, a locally registered stub too, gets the padded shard
    plans; a single-process mesh, or a partition without a mesh, runs the
    serial path."""
    from repro_torch.backends.reference import ReferenceBackend

    class StubBackend(ReferenceBackend):
        name = "test-stub"

    a, b = ab
    stub = StubBackend()
    for mesh, part in ((_mesh(2), None), (None, DistPartition(shards=2))):
        plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                             device="cpu", mesh=mesh, partition=part,
                             backend=stub)
        assert isinstance(plan, ShardedPlan) and plan.backend == "test-stub"
        assert plan.shard_ok and plan.path == "serial"
        np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **TOL)


def test_cuda_shards_padded_like_pallas(ab):
    """cuda shard plans and schedules are padded as JAX's pallas ones."""
    a, b = ab
    tp, jp = _plans(a, b, 2, dataflow="ip_m")
    _same_sharded_plan(tp, jp)
    assert tp.shard_ok
    np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b, **TOL)


def test_partition_override_and_budget_within_shard(ab):
    a, b = ab
    part = DistPartition(axis="m", shards=2)
    plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                         mesh=_mesh(8), partition=part)
    jplan = jax_flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                              mesh=jax_mesh(8),
                              partition=jax_dist.DistPartition(axis="m",
                                                               shards=2))
    _same_sharded_plan(plan, jplan)
    assert plan.axis == "m" and plan.n_shards == 2
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **TOL)
    # a budget small enough to tile within each shard: placement stays
    # orthogonal to tiling — some shards become TiledPlans (serial path)
    tp, jp = _plans(a, b, 2, dataflow="gust_m", budget=(1 << 10, 2 << 10))
    _same_sharded_plan(tp, jp)
    assert any(isinstance(p, TiledPlan) for p in tp.plans)
    np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b, **TOL)
    # a partition without a mesh shards as well
    alone = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                          device="cpu", partition=DistPartition(shards=3))
    assert isinstance(alone, ShardedPlan) and alone.mesh is None
    assert alone.n_shards == 3 and alone.mesh_shape is None
    np.testing.assert_allclose(alone.apply(a, b).numpy(), a @ b, **TOL)


def test_with_backend_retarget(ab):
    a, b = ab
    plan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                         backend="cuda", mesh=_mesh(8))
    sim = plan.with_backend("simulator")
    assert isinstance(sim, ShardedPlan) and sim.backend == "simulator"
    assert sim.mesh is plan.mesh and sim.device == plan.device
    np.testing.assert_allclose(sim.apply(a, b).numpy(),
                               plan.apply(a, b).numpy(), rtol=1e-6, atol=1e-6)
    # the re-targeted plan equals one planned on the simulator outright
    jp = jax_flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                           backend="simulator", mesh=jax_mesh(8))
    _same_sharded_plan(sim, jp)


# ---------------------------------------------------------------------------
# interconnect traffic tier
# ---------------------------------------------------------------------------


def test_report_has_interconnect_tier(ab):
    a, b = ab
    sim, jsim = get_backend("simulator"), jax_get_backend("simulator")
    reps = {}
    for dataflow in ("op_m", "ip_m", "gust_m"):
        p = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                          mesh=_mesh(8), backend=sim)
        jp = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                               mesh=jax_mesh(8), backend="simulator")
        rep, jrep = sim.report(p), jsim.report(jp)
        assert dataclasses.astuple(rep.traffic) == \
            dataclasses.astuple(jrep.traffic)
        assert [dataclasses.astuple(t) for t in rep.per_shard] == \
            [dataclasses.astuple(t) for t in jrep.per_shard]
        reps[dataflow] = (p, rep)
    op, rep = reps["op_m"]
    assert rep.shards == 8 and len(rep.per_shard) == 8
    assert rep.traffic.ici_bytes > 0            # k-slab all-reduce merge
    assert rep.traffic.l1_bytes > 0 and rep.traffic.dram_bytes > 0
    assert rep.traffic.total_bytes >= rep.traffic.ici_bytes
    for dataflow in ("ip_m", "gust_m"):          # disjoint outputs
        assert reps[dataflow][1].traffic.ici_bytes == 0
    assert op.dist_stats["collective"] == "psum"
    assert op.dist_stats["ici_bytes"] == rep.traffic.ici_bytes


def test_report_with_budget_and_padding_shards(ab):
    """report() on a budgeted sharded plan whose shard count does not
    divide the block grid (padding-only shards) prices zero-padded
    slices, as the JAX package does."""
    a, b = ab                    # K grid = 6 blocks, 8 k-slab shards
    sim = get_backend("simulator")
    budget = (1 << 10, 2 << 10)
    tp, jp = _plans(a, b, 8, backend="simulator", dataflow="op_m",
                    budget=budget)
    rep = sim.report(tp)
    assert rep.shards == 8 and rep.traffic.ici_bytes > 0
    assert dataclasses.astuple(rep.traffic) == dataclasses.astuple(
        jax_get_backend("simulator").report(jp).traffic)


def test_sharded_traffic_scaling(ab):
    """More k-slab shards → more interconnect merge traffic; every number
    equals the JAX package's."""
    a, b = ab
    occ_a = block_occupancy(a, BS[:2])
    occ_b = block_occupancy(b, BS[1:])
    t2 = sharded_traffic("op_m", occ_a, occ_b, BS, 2)
    t8 = sharded_traffic("op_m", occ_a, occ_b, BS, 8)
    assert 0 < t2.ici_bytes < t8.ici_bytes
    t_ip = sharded_traffic("ip_m", occ_a, occ_b, BS, 8)
    assert t_ip.ici_bytes == 0
    assert sharded_traffic("op_m", occ_a, occ_b, BS, 1).ici_bytes == 0
    budget = (1 << 10, 2 << 10)
    for dataflow in DATAFLOWS:
        for shards in (1, 2, 8):
            for tiers in (None, budget):
                mine = sharded_traffic(
                    dataflow, occ_a, occ_b, BS, shards,
                    budget=None if tiers is None else MemoryBudget(*tiers))
                want = jax_memory.sharded_traffic(
                    dataflow, occ_a, occ_b, BS, shards,
                    budget=None if tiers is None else JaxBudget(*tiers))
                assert dataclasses.astuple(mine) == dataclasses.astuple(want)


@pytest.mark.parametrize("axis", [None, "m", "k", "n"])
def test_sharded_estimate_equals_jax(axis, ab):
    a, b = ab
    occ_a = block_occupancy(a, BS[:2])
    occ_b = block_occupancy(b, BS[1:])
    shape = LayerShape(32, 48, 40, float(occ_a.mean()), float(occ_b.mean()),
                       BS)
    jshape = JaxLayerShape(32, 48, 40, float(occ_a.mean()),
                           float(occ_b.mean()), BS)
    for dataflow in DATAFLOWS:
        for shards in (1, 4):
            got = sharded_estimate(shape, dataflow, shards, spec=TPU_NUMBERS,
                                   occ_a=occ_a, occ_b=occ_b, axis=axis)
            want = jax_memory.sharded_estimate(jshape, dataflow, shards,
                                               occ_a=occ_a, occ_b=occ_b,
                                               axis=axis)
            assert got == want


@pytest.mark.parametrize("policy", ["heuristic", "simulator"])
def test_policies_rank_with_mesh(policy, ab):
    a, b = ab
    for shards, part in ((8, None), (4, DistPartition(axis="k"))):
        plan = flexagon_plan(a, b, block_shape=BS, mesh=_mesh(shards),
                             partition=part, policy=policy, spec=TPU_NUMBERS)
        jplan = jax_flexagon_plan(
            a, b, block_shape=BS, mesh=jax_mesh(shards), policy=policy,
            partition=None if part is None
            else jax_dist.DistPartition(axis="k"))
        assert isinstance(plan, ShardedPlan)
        assert plan.dataflow == jplan.dataflow and plan.dataflow in DATAFLOWS
        assert plan.axis == jplan.axis


def test_autotune_measures_the_sharded_plan(ab):
    from repro_torch.backends.policies import AutotunePolicy

    a, b = ab
    pol = AutotunePolicy(reps=1)
    plan = flexagon_plan(a, b, block_shape=BS, mesh=_mesh(2), policy=pol)
    assert isinstance(plan, ShardedPlan) and pol.measurements == 1
    assert set(pol.last_timings) >= set(DATAFLOWS)
    # the same pattern on another mesh shape is another measurement
    flexagon_plan(a, b, block_shape=BS, mesh=_mesh(2), policy=pol)
    assert pol.measurements == 1 and pol.hits == 1
    flexagon_plan(a, b, block_shape=BS, mesh=_mesh(4), policy=pol)
    assert pol.measurements == 2
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **TOL)


# ---------------------------------------------------------------------------
# plan cache: mesh identity
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(st.sampled_from([1, 2, 4, 8]), st.sampled_from([1, 2, 4, 8]))
def test_plan_cache_never_crosses_meshes(s1, s2):
    """Property: a plan built for one mesh is never served for another."""
    a, b = _case(seed=3, m=16, k=24, n=16)
    cache = PlanCache()
    m1, m2 = _mesh(s1), _mesh(s2)
    assert mesh_key(m1) == jax_dist.mesh_key(jax_mesh(s1))
    p1 = cache.get(a, b, dataflow="op_m", block_shape=BS, mesh=m1)
    hits_before = cache.hits
    p2 = cache.get(a, b, dataflow="op_m", block_shape=BS, mesh=m2)
    shards1 = p1.n_shards if isinstance(p1, ShardedPlan) else 1
    shards2 = p2.n_shards if isinstance(p2, ShardedPlan) else 1
    assert shards1 == s1 and shards2 == s2
    if mesh_key(m1) == mesh_key(m2):
        assert cache.hits == hits_before + 1 and p2 is p1
    else:
        assert cache.hits == hits_before and p2 is not p1
    # same mesh again → always a hit
    p3 = cache.get(a, b, dataflow="op_m", block_shape=BS, mesh=m2)
    assert p3 is p2


def test_plan_cache_keys_partition_and_mixed(ab):
    a, b = ab
    cache = PlanCache()
    budget = MemoryBudget(1 << 10, 2 << 10)
    p1 = cache.get(a, b, dataflow="mixed", block_shape=BS, mesh=_mesh(2),
                   memory_budget=budget)
    assert isinstance(p1, ShardedPlan) and p1.dataflow == "mixed"
    p2 = cache.get(a, b, dataflow="mixed", block_shape=BS, mesh=_mesh(2),
                   memory_budget=budget, partition=DistPartition(shards=4))
    assert p2 is not p1 and p2.n_shards == 4
    assert cache.get(a, b, dataflow="mixed", block_shape=BS, mesh=_mesh(2),
                     memory_budget=budget) is p1
    assert cache.builds == 2 and cache.hits == 1


# ---------------------------------------------------------------------------
# partitioner + mesh helpers
# ---------------------------------------------------------------------------


def test_partitioner_strategies():
    assert default_axis("ip_m") == "n" and default_axis("ip_n") == "m"
    assert default_axis("op_m") == "k" and default_axis("op_n") == "k"
    assert default_axis("gust_m") == "m" and default_axis("gust_n") == "n"
    part = Partitioner("op_m")
    tiles = part.shard_tiles((4, 6, 5), 4)
    assert len(tiles) == 4
    assert all(t.k1 - t.k0 == 2 for t in tiles)       # uniform padded slabs
    assert tiles[-1].k1 == 8                          # padded past the grid
    # tile-stream placement follows the strategy axis
    stream = [Tile(0, 4, k, k + 2, 0, 5) for k in range(0, 8, 2)]
    assert part.assign(stream, 2) == [0, 0, 1, 1]
    for dataflow in DATAFLOWS + ("mixed",):
        for axis in (None, "m", "k", "n"):
            mine = Partitioner(dataflow, axis=axis)
            ref = jax_dist.Partitioner(dataflow, axis=axis)
            for grid, shards in (((4, 6, 5), 4), ((3, 7, 2), 3)):
                assert [dataclasses.astuple(t)
                        for t in mine.shard_tiles(grid, shards)] == \
                    [dataclasses.astuple(t)
                     for t in ref.shard_tiles(grid, shards)]
                assert mine.padded_grid(grid, shards) == \
                    ref.padded_grid(grid, shards)
    with pytest.raises(ValueError, match="axis"):
        DistPartition(axis="q")
    with pytest.raises(ValueError, match="shards"):
        DistPartition(shards=0)


def test_mesh_helpers():
    local = make_local_mesh("cpu")
    assert local.shape == (1, 1) and local.axis_names == ("data", "model")
    assert mesh_key(local) == ((1, 1), ("data", "model"))
    virtual = _mesh(8)
    assert virtual.axis_names == ("shards",) and virtual.size == 8
    assert virtual.device == torch.device("cpu")
    assert mesh_key(virtual) == jax_dist.mesh_key(jax_mesh(8))
    assert _mesh(1).size == 1 and hash(virtual) == hash(_mesh(8))
    assert mesh_placement(None) is None
    assert mesh_placement(virtual) == mesh_placement(local) == ("single",)
    with pytest.raises(TypeError, match="not a mesh"):
        mesh_placement(object())
    with pytest.raises(ValueError):
        make_virtual_mesh(0, "cpu")
    with pytest.raises(ValueError):
        Mesh((2,), ("a", "b"), torch.device("cpu"))
    # a one-shard mesh plans an ordinary plan on the mesh's device
    a, b = _case(seed=1, m=16, k=16, n=16)
    assert isinstance(flexagon_plan(a, b, block_shape=BS, mesh=local),
                      FlexagonPlan)


@pytest.mark.parametrize("entry", ["flexagon_plan", "PlanCache.get"])
def test_unknown_mesh_type_raises(entry):
    """A mesh is a repro_torch Mesh or a DeviceMesh; anything else is
    refused by name, never taken for one shard."""
    a, b = _case(seed=0)
    call = flexagon_plan if entry == "flexagon_plan" else PlanCache().get
    with pytest.raises(TypeError, match="not a mesh"):
        call(a, b, block_shape=BS, device="cpu", mesh=object())


def test_serve_engine_reports_dist_stats():
    """A sharded CompressedFFN attached to the engine surfaces mesh /
    shard / collective telemetry through ``stats["dist"]``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    ffn, _ = _ffn_case(seed=5)
    comp = compress_ffn(ffn, tokens=2, block=FFN_BLOCK, mesh=_mesh(8),
                        partition=DistPartition(shards=2))
    eng = ServeEngine(model, params, slots=2, max_seq=64, sparse_ffn=comp)
    assert isinstance(eng.decode_ffn.plan_in, ShardedPlan)
    dist = eng.stats["dist"]
    assert dist["shards"] == 2 and dist["mesh_shape"] == (8,)
    assert dist["ici_bytes"] >= 0
    rng = np.random.default_rng(3)
    eng.submit(Request(0, rng.integers(0, cfg.vocab, size=5),
                       max_new_tokens=3))
    eng.run_to_completion()
    assert eng.stats["completed"] == 1
    assert eng.stats["dist"]["shards"] == 2    # survives stat syncs


def test_compressed_ffn_sharded_decode():
    """CompressedFFN(mesh=...) plans sharded matmuls and caches per mesh."""
    from repro_torch.models.sparse_linear import CompressedFFN

    ffn, x = _ffn_case(seed=0)
    full = np.kron(ffn["block_mask"], np.ones((FFN_BLOCK,) * 2, np.float32))
    wg, wu, wd = (torch.as_tensor(ffn[k]["w"] * m) for k, m in
                  (("w_gate", full), ("w_up", full), ("w_down", full.T)))
    comp = CompressedFFN(wg, wu, wd, tokens=FFN_TOKENS, block=FFN_BLOCK,
                         backend="cuda", mesh=_mesh(8),
                         partition=DistPartition(shards=2))
    entry = comp.specialize(FFN_TOKENS)
    assert isinstance(entry.plan_in, ShardedPlan)
    assert entry.plan_in.n_shards == 2 and comp.device.type == "cpu"
    y = sparse_ffn_apply(comp, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y.reshape(FFN_TOKENS, FFN_D),
                               _ffn_reference(ffn, x), **TOL)
    assert comp.plan_builds == 1 and comp.plan_hits >= 1


def test_sharded_apply_records_its_path(ab):
    """The ``dist.sharded.apply`` span carries the path; the serial path
    counts no collective."""
    a, b = ab
    plan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                         backend="cuda", mesh=_mesh(2))
    reg = obs.get_registry()
    before = reg.value("dist.collectives")
    tracer = obs.get_tracer()
    obs.enable()
    try:
        tracer.clear()
        plan.apply(a, b)
        spans = [s for s in tracer.spans()
                 if s.name == "dist.sharded.apply"]
    finally:
        _reset_override()
    assert len(spans) == 1 and spans[0].attrs["path"] == "serial"
    assert spans[0].attrs["collective"] == "psum"
    assert reg.value("dist.collectives") == before


# ---------------------------------------------------------------------------
# the collective path: gloo ranks on the CPU
# ---------------------------------------------------------------------------


def _spawn(world, tmp):
    """Run ``world`` ranks of this file; every rank must exit 0 within
    RANK_TIMEOUT_S.  Returns each rank's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_VERIFY="0",
               OMP_NUM_THREADS="1")
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(store),
         str(tmp / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"gloo{world}"))


@pytest.mark.parametrize("case", ["ip_m", "op_m", "gust_m"])
def test_collective_path_matches_serial_and_jax(case, ranks, ab,
                                                jax_outputs):
    world, results = ranks
    a, b = ab
    serial = flexagon_plan(a, b, dataflow=case, block_shape=BS,
                           backend="cuda", mesh=_mesh(world))
    assert serial.path == "serial"
    want = serial.apply(a, b).numpy()
    for r, res in enumerate(results):
        assert bool(res[f"{case}/collective"]), f"rank {r}: serial path"
        assert int(res[f"{case}/collectives"]) == 1, r
        got = res[f"{case}/out"]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, jax_outputs(case, world), **TOL)
        np.testing.assert_allclose(got, a @ b, **TOL)
        if case != "op_m":
            # disjoint regions merged by adding zeros: exact
            np.testing.assert_array_equal(got, want)


def test_collective_autotune_agrees_across_ranks(ranks, ab):
    """Autotune measures on every rank; all ranks take the first rank's
    pick, so they build one sharded plan and merge it."""
    world, results = ranks
    a, b = ab
    picks = {str(res["autotune/dataflow"]) for res in results}
    assert len(picks) == 1 and picks <= set(DATAFLOWS)
    for r, res in enumerate(results):
        assert bool(res["autotune/collective"]), f"rank {r}: serial path"
        assert int(res["autotune/collectives"]) == 1, r
        np.testing.assert_allclose(res["autotune/out"], a @ b, **TOL)


@pytest.mark.parametrize("dataflow", BUDGET_CASES)
def test_collective_budgeted_shards(dataflow, ranks, ab):
    """Tiled and mixed shards take the collective path too: one shard per
    rank, one merge, the serial result; device=None on a cpu DeviceMesh
    plans on the CPU."""
    world, results = ranks
    a, b = ab
    serial = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                           backend="cuda", mesh=_mesh(world),
                           memory_budget=MemoryBudget(*RANK_BUDGET))
    want = serial.apply(a, b).numpy()
    assert any(isinstance(p, TiledPlan) for p in serial.plans) or \
        dataflow == "mixed"
    name = f"budget_{dataflow}"
    for r, res in enumerate(results):
        assert bool(res[f"{name}/collective"]), f"rank {r}: serial path"
        assert int(res[f"{name}/collectives"]) == 1, r
        assert str(res[f"{name}/device"]) == "cpu"
        assert bool(res[f"{name}/tiled"]) == any(
            isinstance(p, TiledPlan) for p in serial.plans)
        np.testing.assert_allclose(res[f"{name}/out"], want, **TOL)
        np.testing.assert_allclose(res[f"{name}/out"], a @ b, **TOL)


@pytest.mark.parametrize("dataflow", RAGGED_CASES)
def test_collective_ragged_shapes(dataflow, ranks):
    """Ragged operands on the collective path: a rank whose shard lies in
    the grid's padding adds zeros; the merge gives the serial result."""
    world, results = ranks
    a, b = _case(**RAGGED)
    serial = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                           backend="cuda", mesh=_mesh(world))
    want = serial.apply(a, b).numpy()
    name = f"ragged_{dataflow}"
    for r, res in enumerate(results):
        assert bool(res[f"{name}/collective"]), f"rank {r}: serial path"
        assert int(res[f"{name}/collectives"]) == 1, r
        got = res[f"{name}/out"]
        assert got.shape == (5, 37)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, a @ b, **TOL)
        if dataflow != "op_m":
            np.testing.assert_array_equal(got, want)


def test_fewer_ranks_than_shards_is_serial(ranks, ab):
    """A DeviceMesh with fewer ranks than shards runs every shard on each
    rank and merges nothing."""
    world, results = ranks
    a, b = ab
    for r, res in enumerate(results):
        assert bool(res["over/serial"]), r
        assert int(res["over/collectives"]) == 0, r
        np.testing.assert_allclose(res["over/out"], a @ b, **TOL)


def test_plan_cache_and_autotune_key_the_mesh_kind(ranks):
    """A single-process mesh and a DeviceMesh of one shape share no plan
    and no autotune measurement."""
    world, results = ranks
    for r, res in enumerate(results):
        assert list(res["cache/paths"]) == ["serial", "collective"] * 2, r
        assert int(res["cache/builds"]) == 4, r
        assert int(res["cache/measurements"]) == 2, r


def test_collective_sharded_ffn(ranks):
    world, results = ranks
    params, x = _ffn_case()
    want = _ffn_reference(params, x)
    comp = compress_ffn(params, tokens=FFN_TOKENS, block=FFN_BLOCK,
                        backend="cuda", mesh=_mesh(world))
    serial = sparse_ffn_apply(comp, torch.as_tensor(x)).numpy()
    for r, res in enumerate(results):
        assert bool(res["ffn/collective"]), f"rank {r}: serial path"
        # gate, up and down: three sharded applies, one merge each
        assert int(res["ffn/collectives"]) == 3, r
        got = res["ffn/out"].reshape(FFN_TOKENS, FFN_D)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, serial.reshape(FFN_TOKENS, FFN_D),
                                   **TOL)
