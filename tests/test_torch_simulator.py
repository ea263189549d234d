"""The port's cycle-level simulator, MRN model, workload tables and
``simulator`` backend against the JAX package's.

All of it is numpy, so every number must be *equal* to the JAX package's
on the same inputs: ``SimResult`` fields for every Table 6 layer on every
accelerator model, ``SimulatorBackend.cost`` for the six dataflows and
``report`` of a plan, MRN merge/reduce results, Table 2 and
``model_layers``, and the area/power model.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import flexagon_plan as jax_flexagon_plan
from repro import get_backend as jax_get_backend
from repro.core import mrn as jax_mrn
from repro.core import simulator as jax_sim
from repro.core import workloads as jax_wl
from repro.core.formats import random_sparse_dense
from repro.core.selector import LayerShape as JaxLayerShape

from repro_torch import flexagon_plan, get_backend
from repro_torch.core import mrn
from repro_torch.core import simulator as sim
from repro_torch.core import workloads as wl
from repro_torch.core.dataflows import DATAFLOWS
from repro_torch.core.selector import LayerShape

BS = (8, 8, 8)


@pytest.fixture(autouse=True)
def _no_verify(monkeypatch):
    # the port has no plan verifier yet (ROADMAP item 10): verify=True and
    # REPRO_VERIFY=1 raise, so these tests plan with verification off
    monkeypatch.setenv("REPRO_VERIFY", "0")


def _fields(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("name", sorted(jax_wl.PAPER_LAYERS))
def test_sim_results_equal_on_table6(name):
    spec = wl.PAPER_LAYERS[name]
    assert _fields(spec) == _fields(jax_wl.PAPER_LAYERS[name])
    mine, ref = sim.from_layer(spec), jax_sim.from_layer(
        jax_wl.PAPER_LAYERS[name])
    for f in ("nnz_a", "nnz_b", "nnz_c", "mults"):
        assert getattr(mine, f) == getattr(ref, f)
    for f in ("a_row_nnz", "a_col_nnz", "b_row_nnz", "b_col_nnz",
              "row_psums"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert list(sim.ACCELERATORS) == list(jax_sim.ACCELERATORS)
    for acc in sim.ACCELERATORS:
        got, want = sim.simulate(acc, mine), jax_sim.simulate(acc, ref)
        assert _fields(got) == _fields(want), acc
        assert got.cycles == want.cycles and got.miss_rate == want.miss_rate


@settings(max_examples=10, deadline=None)
@given(st.integers(8, 96), st.integers(8, 160), st.integers(8, 96),
       st.floats(0, 95), st.floats(0, 95), st.integers(0, 3))
def test_sim_results_equal_on_random_layers(m, n, k, sp_a, sp_b, seed):
    mine = sim.from_layer(sim.LayerSpec("t", m, n, k, sp_a, sp_b), seed=seed)
    ref = jax_sim.from_layer(jax_sim.LayerSpec("t", m, n, k, sp_a, sp_b),
                             seed=seed)
    for acc in sim.ACCELERATORS:
        assert _fields(sim.simulate(acc, mine)) == \
            _fields(jax_sim.simulate(acc, ref))


def test_paper_layer_winners_in_the_port():
    """Fig 13 grouping: each layer is won by its paper-assigned model."""
    best = {"ip": "sigma_like", "op": "sparch_like", "gust": "gamma_like"}
    for group, names in wl.PAPER_LAYER_GROUPS.items():
        for name in names:
            st_ = sim.from_layer(wl.PAPER_LAYERS[name])
            cyc = {a: sim.simulate(a, st_).cycles for a in best.values()}
            assert min(cyc, key=cyc.get) == best[group], (name, cyc)


def test_area_and_power_equal():
    for acc in sim.ACCELERATORS:
        assert sim.accelerator_area(acc) == jax_sim.accelerator_area(acc)
        assert sim.accelerator_power(acc) == jax_sim.accelerator_power(acc)
    assert _fields(sim.naive_design_area()) == \
        _fields(jax_sim.naive_design_area())
    assert sim.perf_per_area(1e6, "flexagon", 2e6) == \
        jax_sim.perf_per_area(1e6, "flexagon", 2e6)
    assert _fields(sim.PAPER_CONFIG) == _fields(jax_sim.PAPER_CONFIG)


def test_table2_and_model_layers_equal():
    assert [_fields(m) for m in wl.TABLE2] == \
        [_fields(m) for m in jax_wl.TABLE2]
    assert wl.CPU_CYCLES_1E6 == jax_wl.CPU_CYCLES_1E6
    assert wl.PAPER_LAYER_GROUPS == jax_wl.PAPER_LAYER_GROUPS
    for name, info in wl.MODELS.items():
        layers = wl.model_layers(name)
        assert len(layers) == info.nl
        assert [_fields(x) for x in layers] == \
            [_fields(x) for x in jax_wl.model_layers(name)]


# -- MRN ----------------------------------------------------------------------


def _fibers(rng, n_fibers):
    out = []
    for _ in range(n_fibers):
        n = int(rng.integers(0, 10))
        coords = np.sort(rng.choice(31, size=n, replace=False)).astype(
            np.int64)
        out.append((coords, rng.standard_normal(n)))
    return out


@pytest.mark.parametrize("leaves", [2, 4, 64])
@pytest.mark.parametrize("seed", range(4))
def test_mrn_merge_equal(seed, leaves):
    fibers = _fibers(np.random.default_rng(seed), 1 + seed * 4)
    (c, v), stats = mrn.merge_fibers(fibers, leaves=leaves)
    (jc, jv), jstats = jax_mrn.merge_fibers(fibers, leaves=leaves)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(v, jv)
    assert _fields(stats) == _fields(jstats)


@pytest.mark.parametrize("seed", range(4))
def test_mrn_reduce_and_passes_equal(seed):
    rng = np.random.default_rng(seed)
    sizes = list(rng.integers(0, 8, size=1 + seed * 3))
    values = rng.standard_normal(sum(sizes))
    out, stats = mrn.reduce_clusters(values, sizes)
    jout, jstats = jax_mrn.reduce_clusters(values, sizes)
    np.testing.assert_array_equal(out, jout)
    assert _fields(stats) == _fields(jstats)
    for n in (0, 1, 63, 64, 65, 100, 5000):
        assert mrn.mrn_passes(n, 64) == jax_mrn.mrn_passes(n, 64)


# -- the simulator backend ----------------------------------------------------


def _case(seed=0, m=24, k=40, n=32, da=0.4, db=0.6):
    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


@pytest.mark.parametrize("dims", [(64, 64, 64, 0.3, 0.5),
                                  (128, 512, 96, 0.1, 0.9),
                                  (32, 16, 300, 1.0, 0.2)])
def test_simulator_cost_equal_for_six_dataflows(dims):
    m, k, n, da, db = dims
    be, jbe = get_backend("simulator"), jax_get_backend("simulator")
    for d in DATAFLOWS:
        got = be.cost(LayerShape(m=m, k=k, n=n, density_a=da, density_b=db),
                      d)
        want = jbe.cost(JaxLayerShape(m=m, k=k, n=n, density_a=da,
                                      density_b=db), d)
        assert got == want > 0, d


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_simulator_report_and_execute(dataflow):
    a, b = _case(seed=12)
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend="simulator", device="cpu")
    jplan = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                              backend="simulator")
    got = get_backend("simulator").report(plan)
    want = jax_get_backend("simulator").report(jplan)
    assert _fields(got) == _fields(want)
    # execution is the reference executors', on the operands' device
    out = plan.apply(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(jplan.apply(a, b)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)
