"""The port's selection policies and ``FlexagonPipeline`` against the JAX
package's.

- ``policy="simulator"`` picks what the JAX package picks (cycle models,
  with and without a memory budget), and its ``layer_cost`` is equal;
- the budget-aware heuristic picks what the JAX package picks under the
  JAX package's ``TPUSpec`` numbers;
- ``policy="autotune"`` picks an allowed dataflow, a second select on the
  same pattern hits its cache, its ``stats`` carry the reference's keys,
  and what is not ported (``TuneDB``, a mesh, ``learned``) raises;
- ``FlexagonPipeline``'s dataflows and output match the JAX package's,
  with and without a budget.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import FlexagonPipeline as JaxPipeline
from repro import MemoryBudget as JaxBudget
from repro import flexagon_plan as jax_flexagon_plan
from repro.backends.policies import AutotunePolicy as JaxAutotune
from repro.backends.policies import HeuristicPolicy as JaxHeuristicPolicy
from repro.backends.policies import SimulatorPolicy as JaxSimulatorPolicy
from repro.core.formats import random_sparse_dense
from repro.core.selector import LayerShape as JaxLayerShape
from repro.core.selector import TPUSpec

from repro_torch import (FlexagonPipeline, MemoryBudget, TiledPlan,
                         flexagon_plan, get_backend, get_policy)
from repro_torch.backends import (AutotunePolicy, CudaBackend,
                                  HeuristicPolicy, SelectionContext,
                                  SimulatorPolicy)
from repro_torch.backends.base import _REGISTRY
from repro_torch.core.dataflows import DATAFLOWS
from repro_torch.core.selector import DeviceSpec, LayerShape

BS = (8, 8, 8)
TOL = dict(rtol=1e-4, atol=1e-4)
DENSE_TOL = dict(rtol=1e-3, atol=1e-3)
TPU_NUMBERS = DeviceSpec(**dataclasses.asdict(TPUSpec()))
SMALL = (4096, 8192)
TINY = (1024, 2048)


@pytest.fixture(autouse=True)
def _no_verify(monkeypatch):
    # the port has no plan verifier yet (ROADMAP item 10): verify=True and
    # REPRO_VERIFY=1 raise, so these tests plan with verification off
    monkeypatch.setenv("REPRO_VERIFY", "0")


def _case(seed=0, m=24, k=40, n=32, da=0.4, db=0.6):
    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


DENSITIES = [(0.2, 0.9), (0.9, 0.1), (0.5, 0.5), (1.0, 0.3), (0.3, 1.0)]


@pytest.mark.parametrize("budget", [None, SMALL])
@pytest.mark.parametrize("seed,dens", list(enumerate(DENSITIES)))
def test_simulator_policy_picks_as_jax(seed, dens, budget):
    a, b = _case(seed=seed, m=48, k=64, n=40, da=dens[0], db=dens[1])
    kw = {} if budget is None else {"memory_budget": MemoryBudget(*budget)}
    jkw = {} if budget is None else {"memory_budget": JaxBudget(*budget)}
    tp = flexagon_plan(a, b, block_shape=BS, policy="simulator",
                       device="cpu", **kw)
    jp = jax_flexagon_plan(a, b, block_shape=BS, policy="simulator", **jkw)
    assert tp.dataflow == jp.dataflow
    assert flexagon_plan(a, b, block_shape=BS, policy="simulator",
                         device="cpu", **kw).dataflow == tp.dataflow
    np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b, **DENSE_TOL)


@pytest.mark.parametrize("seed,dens", list(enumerate(DENSITIES)))
def test_budget_aware_heuristic_picks_as_jax(seed, dens):
    a, b = _case(seed=seed, m=48, k=64, n=40, da=dens[0], db=dens[1])
    for tiers in (SMALL, TINY):
        tp = flexagon_plan(a, b, block_shape=BS, device="cpu",
                           spec=TPU_NUMBERS,
                           memory_budget=MemoryBudget(*tiers))
        jp = jax_flexagon_plan(a, b, block_shape=BS,
                               memory_budget=JaxBudget(*tiers))
        assert tp.dataflow == jp.dataflow
        assert isinstance(tp, TiledPlan) == hasattr(jp, "tiles")


@pytest.mark.parametrize("budget", [None, SMALL])
def test_layer_costs_equal(budget):
    mine = None if budget is None else MemoryBudget(*budget)
    ref = None if budget is None else JaxBudget(*budget)
    for dims in ((64, 512, 512, 1.0, 0.4), (16, 96, 160, 0.7, 0.2)):
        shape, jshape = LayerShape(*dims, BS), JaxLayerShape(*dims, BS)
        for d in DATAFLOWS:
            assert SimulatorPolicy().layer_cost(shape, d, None, mine) == \
                JaxSimulatorPolicy().layer_cost(jshape, d, None, ref)
            assert HeuristicPolicy().layer_cost(
                shape, d, TPU_NUMBERS, mine) == \
                JaxHeuristicPolicy().layer_cost(jshape, d, TPUSpec(), ref)
            assert AutotunePolicy().layer_cost(shape, d, TPU_NUMBERS,
                                               mine) == \
                JaxAutotune().layer_cost(jshape, d, TPUSpec(), ref)


def test_named_policies():
    assert get_policy("autotune") is get_policy("autotune")
    assert isinstance(get_policy("simulator"), SimulatorPolicy)
    assert isinstance(get_policy(None), HeuristicPolicy)
    assert get_policy("simulator", "mixed") is get_policy("simulator")
    with pytest.raises(KeyError, match="unknown policy"):
        get_policy("nope")
    with pytest.raises(NotImplementedError, match="item 11"):
        get_policy("learned")


@pytest.fixture
def own_cuda(monkeypatch):
    """A cuda backend of the test's own, registered for the test alone, so
    autotune's knob writes do not touch the registered ``cuda`` instance."""
    be = CudaBackend()
    be.name = "test-autotune-cuda"
    monkeypatch.setitem(_REGISTRY, be.name, be)
    return be


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_autotune_picks_allowed_and_caches(backend, own_cuda):
    be = get_backend("reference") if backend == "reference" else own_cuda
    a, b = _case(seed=10, m=16, k=16, n=16)
    pol = AutotunePolicy(reps=1)
    plan = flexagon_plan(a, b, block_shape=BS, policy=pol, backend=be,
                         device="cpu")
    assert plan.dataflow in DATAFLOWS
    assert (pol.measurements, pol.hits, pol.misses) == (1, 0, 1)
    n_knobs = len(be.tuning_knobs().get("dense_threshold", (0,)))
    assert len(pol.last_timings) == len(DATAFLOWS) * n_knobs
    assert all(t > 0 for t in pol.last_timings.values())
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **TOL)
    # same pattern, new values: a cache hit, the same answer, no sweep
    again = flexagon_plan(a * 2.0, b * 0.5, block_shape=BS, policy=pol,
                          backend=be, device="cpu")
    assert again.dataflow == plan.dataflow
    assert (pol.measurements, pol.hits) == (1, 1)
    # a different pattern sweeps again
    a2, _ = _case(seed=11, m=16, k=16, n=16, da=0.9)
    flexagon_plan(a2, b, block_shape=BS, policy=pol, backend=be,
                  device="cpu")
    assert pol.measurements == 2
    assert set(pol.stats) == set(JaxAutotune(reps=1).stats)
    assert pol.stats["name"] == "autotune" and pol.stats["size"] == 2


def test_autotune_knobs_land_on_the_measured_backend(own_cuda):
    be = own_cuda
    before = get_backend("cuda").dense_threshold
    a, b = _case(seed=12, m=16, k=16, n=16)
    pol = AutotunePolicy(reps=1)
    flexagon_plan(a, b, block_shape=BS, policy=pol, backend=be, device="cpu")
    assert be.dense_threshold in be.tuning_knobs()["dense_threshold"]
    assert get_backend("cuda").dense_threshold == before


def test_autotune_with_budget_measures_tiled_plans():
    a, b = _case(seed=13, m=48, k=64, n=40, da=0.5, db=0.6)
    pol = AutotunePolicy(reps=1)
    plan = flexagon_plan(a, b, block_shape=BS, policy=pol, device="cpu",
                         memory_budget=MemoryBudget(*SMALL))
    assert isinstance(plan, TiledPlan) and plan.dataflow in DATAFLOWS
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **DENSE_TOL)
    flexagon_plan(a, b, block_shape=BS, policy=pol, device="cpu",
                  memory_budget=MemoryBudget(*SMALL))
    assert (pol.measurements, pol.hits) == (1, 1)
    # the budget is part of the key: unbudgeted is another sweep
    flexagon_plan(a, b, block_shape=BS, policy=pol, device="cpu")
    assert pol.measurements == 2


def test_mixed_autotune_measures_per_tile():
    rng = np.random.default_rng(7)
    a = np.zeros((32, 32), np.float32)
    a[:16] = rng.standard_normal((16, 32))
    a[16:] = random_sparse_dense(rng, (16, 32), density=0.3,
                                 block_shape=BS[:2])
    b = random_sparse_dense(rng, (32, 32), density=0.8, block_shape=BS[1:])
    pol = AutotunePolicy(reps=1)
    budget = MemoryBudget(l1_bytes=2100, l2_bytes=6000)
    plan = flexagon_plan(a, b, dataflow="mixed", block_shape=BS,
                         memory_budget=budget, policy=pol, device="cpu")
    assert isinstance(plan, TiledPlan)
    assert pol.measurements == plan.n_tiles
    assert set(plan.tile_dataflows) <= set(DATAFLOWS)
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **DENSE_TOL)
    flexagon_plan(a, b, dataflow="mixed", block_shape=BS,
                  memory_budget=budget, policy=pol, device="cpu")
    assert pol.measurements == plan.n_tiles


def test_autotune_select_block():
    a, b = _case(seed=14, m=32, k=32, n=32)
    occ_a = np.ones((4, 4), bool)
    occ_b = np.ones((4, 4), bool)
    ctx = SelectionContext(
        shape=LayerShape(32, 32, 32, 1.0, 1.0, BS), block_shape=BS,
        occ_a=occ_a, occ_b=occ_b, fingerprint="select-block-test",
        backend=get_backend("reference"), spec=DeviceSpec(),
        allowed=DATAFLOWS, device="cpu")
    pol = AutotunePolicy(reps=1)
    cands = ((8, 8, 8), (16, 16, 16))
    best = pol.select_block(ctx, cands)
    assert best in cands and pol.measurements == 1
    assert pol.select_block(ctx, cands) == best and pol.hits == 1
    with pytest.raises(ValueError, match="candidate"):
        pol.select_block(ctx, ())


def test_unported_autotune_parts_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 11"):
        AutotunePolicy(db="/nonexistent/tune.json")
    monkeypatch.setenv("REPRO_TUNE_DB", "tune.json")
    with pytest.raises(NotImplementedError, match="item 11"):
        AutotunePolicy()


def test_policies_select_with_a_mesh():
    """A mesh in the context (which raised until the distribution slice)
    makes every policy price the sharded execution: each picks an allowed
    dataflow, and autotune keys its cache by the mesh's shape."""
    from repro_torch.core.formats import block_occupancy
    from repro_torch.launch.mesh import make_virtual_mesh

    rng = np.random.default_rng(3)
    a = random_sparse_dense(rng, (16, 16), density=0.6, block_shape=BS[:2])
    b = random_sparse_dense(rng, (16, 16), density=0.6, block_shape=BS[:2])
    occ_a = block_occupancy(a, BS[:2])
    occ_b = block_occupancy(b, BS[1:])
    auto = AutotunePolicy(reps=1)
    for shards in (2, 4):
        ctx = SelectionContext(
            shape=LayerShape(16, 16, 16, float(occ_a.mean()),
                             float(occ_b.mean()), BS),
            block_shape=BS, occ_a=occ_a, occ_b=occ_b, fingerprint="mesh",
            backend=get_backend("reference"), spec=DeviceSpec(),
            allowed=DATAFLOWS, mesh=make_virtual_mesh(shards, "cpu"),
            device="cpu")
        assert ctx.n_shards == shards
        for pol in (auto, HeuristicPolicy(), SimulatorPolicy()):
            assert pol.select(ctx) in DATAFLOWS
    assert auto.measurements == 2 and auto.misses == 2


# -- FlexagonPipeline ---------------------------------------------------------


@pytest.mark.parametrize("policy", ["heuristic", "simulator"])
@pytest.mark.parametrize("budget", [None, TINY])
def test_pipeline_matches_jax(budget, policy):
    rng = np.random.default_rng(11)
    ws = [random_sparse_dense(rng, (40, 32), density=0.5, block_shape=BS[:2]),
          random_sparse_dense(rng, (32, 24), density=0.6, block_shape=BS[:2]),
          random_sparse_dense(rng, (24, 40), density=0.4, block_shape=BS[:2])]
    x = rng.standard_normal((48, 40)).astype(np.float32)
    kw = {} if budget is None else {"memory_budget": MemoryBudget(*budget)}
    jkw = {} if budget is None else {"memory_budget": JaxBudget(*budget)}
    pipe = FlexagonPipeline.from_weights(
        ws, tokens=48, block_shape=BS, spec=TPU_NUMBERS, policy=policy,
        backend="cuda", device="cpu", **kw)
    jpipe = JaxPipeline.from_weights(ws, tokens=48, block_shape=BS,
                                     policy=policy, **jkw)
    assert pipe.dataflows == list(jpipe.dataflows)
    assert pipe.conversions == list(jpipe.conversions)
    assert pipe.n_conversions == jpipe.n_conversions
    assert pipe.majors == jpipe.majors
    assert [isinstance(p, TiledPlan) for p in pipe.plans] == \
        [hasattr(p, "tiles") for p in jpipe.plans]
    if budget is not None:
        assert any(isinstance(p, TiledPlan) for p in pipe.plans)
    out = pipe.apply(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jpipe.apply(x)), **TOL)
    np.testing.assert_allclose(out, x @ ws[0] @ ws[1] @ ws[2], **DENSE_TOL)


def test_pipeline_pinned_dataflows_and_mesh():
    rng = np.random.default_rng(12)
    ws = [random_sparse_dense(rng, (16, 24), density=0.5, block_shape=BS[:2]),
          random_sparse_dense(rng, (24, 16), density=0.5, block_shape=BS[:2])]
    pipe = FlexagonPipeline.from_weights(ws, tokens=8, block_shape=BS,
                                         dataflows=["op_n", "gust_m"],
                                         device="cpu")
    assert pipe.dataflows == ["op_n", "gust_m"] and pipe.n_conversions == 1
    x = rng.standard_normal((8, 16)).astype(np.float32)
    np.testing.assert_allclose(pipe(torch.as_tensor(x)).numpy(),
                               x @ ws[0] @ ws[1], **TOL)
    from repro_torch.dist import ShardedPlan
    from repro_torch.launch.mesh import make_virtual_mesh

    sharded = FlexagonPipeline.from_weights(
        ws, tokens=8, block_shape=BS, dataflows=["op_n", "gust_m"],
        backend="cuda", mesh=make_virtual_mesh(2, "cpu"))
    assert all(isinstance(p, ShardedPlan) and p.n_shards == 2
               for p in sharded.plans)
    np.testing.assert_allclose(sharded(torch.as_tensor(x)).numpy(),
                               x @ ws[0] @ ws[1], **TOL)
    with pytest.raises(ValueError, match="K="):
        FlexagonPipeline.from_weights([ws[0], ws[0]], tokens=8,
                                      block_shape=BS, device="cpu")
