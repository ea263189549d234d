"""The port's plan API on the CPU against the JAX package's.

All six dataflows and the dense escape through
``flexagon_plan(..., backend="cuda", device="cpu")`` (the kernels' plain
versions) against JAX ``backend="pallas"`` in interpret mode, with
``rtol=atol=1e-4``; the plan-once contract (``PHASE1_COUNTERS``, no
host→device copy of plan arrays on ``apply``); ``PlanCache``; ``mesh=``
and ``partition=``; the ``learned`` policy and the ``verify=`` gate.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import flexagon_plan as jax_flexagon_plan
from repro.core.formats import random_sparse_dense

import repro_torch
from repro_torch import (PHASE1_COUNTERS, PlanCache, SparseOperand,
                         compress_ffn, flexagon_plan, get_backend,
                         get_policy)
from repro_torch.analysis import PlanVerificationError, errors_of, verify_plan
from repro_torch.backends import CudaBackend
from repro_torch.core.dataflows import DATAFLOWS


TOL = dict(rtol=1e-4, atol=1e-4)
BS = (8, 8, 8)


def _case(seed=0, m=32, k=48, n=40, da=0.4, db=0.6):
    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_six_dataflows_match_pallas(dataflow, backend):
    a, b = _case(seed=1)
    want = np.asarray(jax_flexagon_plan(a, b, dataflow=dataflow,
                                        block_shape=BS, backend="pallas")
                      .apply(a, b))
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend=backend, device="cpu")
    assert plan.dataflow == dataflow and "dense" not in plan.aux
    got = plan.apply(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)
    packed = plan.apply(plan.pack_a(a), plan.pack_b(b))
    torch.testing.assert_close(packed, got, rtol=0, atol=0)


@pytest.mark.parametrize("dataflow", ["ip_m", "op_n", "gust_m", "auto"])
def test_dense_escape_matches_pallas(dataflow):
    a, b = _case(seed=2, da=0.9, db=0.9)
    jp = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                           backend="pallas")
    tp = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                       backend="cuda", device="cpu")
    assert "dense" in jp.aux and "dense" in tp.aux
    np.testing.assert_allclose(tp.apply(a, b).numpy(),
                               np.asarray(jp.apply(a, b)), **TOL)


def test_auto_choice_matches_pallas_under_tpu_numbers():
    import dataclasses

    from repro.core.selector import TPUSpec
    from repro_torch.core.selector import DeviceSpec

    spec = DeviceSpec(**dataclasses.asdict(TPUSpec()))
    for seed, (da, db) in enumerate([(0.2, 0.9), (0.9, 0.1), (0.5, 0.5)]):
        a, b = _case(seed=seed, da=da, db=db)
        jp = jax_flexagon_plan(a, b, block_shape=BS, backend="pallas")
        tp = flexagon_plan(a, b, block_shape=BS, backend="cuda",
                           device="cpu", spec=spec)
        assert jp.dataflow == tp.dataflow
        assert jp.fingerprint == tp.fingerprint


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_apply_does_no_phase1_work_and_no_upload(backend, monkeypatch):
    a, b = _case(seed=3)
    plans = [flexagon_plan(a, b, dataflow=d, block_shape=BS, backend=backend,
                           device="cpu") for d in DATAFLOWS]
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    before = dict(PHASE1_COUNTERS)
    uploads = []
    real_as_tensor = torch.as_tensor

    def counting_as_tensor(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            uploads.append(x.shape)
        return real_as_tensor(x, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting_as_tensor)
    for plan in plans:
        for _ in range(2):
            out = plan.apply(ta, tb)
            np.testing.assert_allclose(out.numpy(), a @ b, **TOL)
    assert PHASE1_COUNTERS == before
    assert uploads == [], "apply copied host arrays to the device"


def test_plan_reuse_same_pattern_new_values():
    a, b = _case(seed=7)
    plan = flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu")
    before = dict(PHASE1_COUNTERS)
    for scale in (1.0, -2.5, 100.0):
        a2, b2 = a * scale, b * 0.5
        np.testing.assert_allclose(plan.apply(a2, b2).numpy(), a2 @ b2,
                                   **TOL)
    assert PHASE1_COUNTERS == before
    assert plan.matches(a * 7.0, b)
    a_other, _ = _case(seed=99, da=0.15)
    assert not plan.matches(a_other, b)


def test_with_backend_shares_phase1():
    a, b = _case(seed=8)
    plan = flexagon_plan(a, b, dataflow="gust_n", block_shape=BS,
                         backend="cuda", device="cpu")
    ref = plan.with_backend("reference")
    assert ref.backend == "reference" and ref.index_plan is plan.index_plan
    torch.testing.assert_close(ref.apply(a, b), plan.apply(a, b), **TOL)


def test_plan_cache_counters_and_lru():
    a, b = _case(seed=4)
    cache = PlanCache(maxsize=2)
    p1 = cache.get(a, b, block_shape=BS, backend="cuda", device="cpu")
    p2 = cache.get(a * 3.0, b, block_shape=BS, backend="cuda", device="cpu")
    assert p1 is p2 and (cache.builds, cache.hits) == (1, 1)
    cache.get(a, b, dataflow="op_m", block_shape=BS, backend="cuda",
              device="cpu")
    assert cache.builds == 2 and len(cache) == 2
    a3, _ = _case(seed=5, da=0.2)
    cache.get(a3, b, block_shape=BS, backend="cuda", device="cpu")
    assert cache.evictions == 1 and len(cache) == 2
    assert cache.stats == {"hits": 1, "misses": 3, "evictions": 1,
                           "size": 2, "maxsize": 2}


def test_sparse_operand_round_trip():
    a, _ = _case(seed=6)
    for fmt in ("bcsr", "bcsc"):
        op = SparseOperand.from_dense(a, fmt, BS[:2], device="cpu")
        np.testing.assert_array_equal(op.todense().numpy(), a)
        other = op.convert("bcsc" if fmt == "bcsr" else "bcsr")
        np.testing.assert_array_equal(other.todense().numpy(), a)
    for fmt in ("csr", "csc"):
        op = SparseOperand.from_dense(a, fmt)
        np.testing.assert_array_equal(op.todense(), a)


@pytest.mark.parametrize("kwarg", ["mesh", "partition"])
def test_mesh_and_partition_shard_the_plan(kwarg):
    """``mesh=`` and ``partition=`` (which raised until the distribution
    slice) give a sharded plan, from ``flexagon_plan`` and from the
    cache, whose result is ``a @ b``."""
    from repro_torch.dist import DistPartition, ShardedPlan
    from repro_torch.launch.mesh import make_virtual_mesh

    a, b = _case(seed=0)
    kw = {"mesh": make_virtual_mesh(2, "cpu")} if kwarg == "mesh" \
        else {"partition": DistPartition(shards=2)}
    for plan in (flexagon_plan(a, b, block_shape=BS, device="cpu", **kw),
                 PlanCache().get(a, b, block_shape=BS, device="cpu", **kw)):
        assert isinstance(plan, ShardedPlan) and plan.n_shards == 2
        np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **TOL)


@pytest.mark.parametrize("policy", ["learned"])
def test_unported_policies_raise(policy, monkeypatch):
    """``"learned"`` (which raised until the tune slice) resolves to one
    ``LearnedPolicy``; without ``REPRO_TUNE_MODEL`` it is model-less and
    plans through its heuristic fallback."""
    from repro_torch.backends import policies
    from repro_torch.tune import LearnedPolicy

    monkeypatch.delenv("REPRO_TUNE_MODEL", raising=False)
    monkeypatch.setattr(policies, "_NAMED", {})
    pol = get_policy(policy)
    assert isinstance(pol, LearnedPolicy) and get_policy(policy) is pol
    a, b = _case(seed=0)
    plan = flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu",
                         policy=policy)
    assert plan.dataflow == flexagon_plan(
        a, b, block_shape=BS, backend="cuda", device="cpu").dataflow
    assert pol.fallbacks == 1 and pol.stats["model"] is None


class _BadScheduleBackend(CudaBackend):
    """A cuda backend whose ``prepare`` aims the first real run outside
    the output grid: every plan it prepares is corrupt."""

    name = "test-bad-schedule"

    def prepare(self, plan):
        aux = super().prepare(plan)
        s = aux["stream_schedule"]
        run_ci = np.asarray(s.run_ci).copy()
        run_ci[0] = 10_000
        aux["stream_schedule"] = dataclasses.replace(s, run_ci=run_ci)
        return aux


def test_verify_is_accepted(monkeypatch):
    """``verify=True``, and the ``REPRO_VERIFY=1`` default, verify every
    plan build: a clean plan passes, and a plan that a faulty backend
    prepares raises ``PlanVerificationError`` in ``flexagon_plan``,
    ``PlanCache.get`` and ``compress_ffn`` alike.  ``verify=False`` hands
    out even the corrupt plan, which the verifier then flags."""
    from repro_torch.backends.base import _REGISTRY

    a, b = _case(seed=0)
    bad = _BadScheduleBackend()
    monkeypatch.setitem(_REGISTRY, bad.name, bad)     # removed afterwards
    kw = dict(block_shape=BS, device="cpu")
    params = {"w_gate": {"w": torch.ones(16, 16)},
              "w_up": {"w": torch.ones(16, 16)},
              "w_down": {"w": torch.ones(16, 16)},
              "block_mask": torch.ones(2, 2)}
    for env, verify in (("0", True), ("1", None)):
        monkeypatch.setenv("REPRO_VERIFY", env)
        plan = flexagon_plan(a, b, verify=verify, backend="cuda", **kw)
        np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, **TOL)
        assert PlanCache().get(a, b, verify=verify, backend="cuda",
                               **kw).dataflow == plan.dataflow
        with pytest.raises(PlanVerificationError) as exc:
            flexagon_plan(a, b, verify=verify, backend=bad, **kw)
        assert "schedule-bounds" in {d.code for d in exc.value.diagnostics}
        with pytest.raises(PlanVerificationError):
            PlanCache().get(a, b, verify=verify, backend=bad, **kw)
        with pytest.raises(PlanVerificationError):
            compress_ffn(params, tokens=4, block=8, device="cpu",
                         backend=bad, verify=verify)
    monkeypatch.setenv("REPRO_VERIFY", "1")
    corrupt = flexagon_plan(a, b, verify=False, backend=bad, **kw)
    assert errors_of(verify_plan(corrupt))


def test_registry_has_both_backends():
    assert repro_torch.available_backends() == ("cuda", "reference",
                                                "simulator")
    assert get_backend("cuda").dense_threshold == 0.5


@pytest.mark.parametrize("dataflow", ["ip_m", "op_m", "ip_n", "op_n"])
def test_apply_with_split_runs_makes_no_upload(dataflow, monkeypatch):
    """A plan whose long runs K1 cuts into chunks: the chunk table is built
    and uploaded once, at plan time, and ``apply`` copies nothing."""
    a, b = _case(seed=5, m=16, k=8 * 16, n=16, da=1.0, db=1.0)
    # escape off: the kernel path, not the dense product
    monkeypatch.setattr(get_backend("cuda"), "dense_threshold", 2.0)
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend="cuda", device="cpu")
    assert "dense" not in plan.aux
    ds = plan.aux["device_schedule"]
    assert ds.n_split > 0 and ds.n_chunk > ds.n_seg
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    before = dict(PHASE1_COUNTERS)
    uploads = []
    real_as_tensor = torch.as_tensor

    def counting_as_tensor(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            uploads.append(x.shape)
        return real_as_tensor(x, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting_as_tensor)
    for _ in range(2):
        np.testing.assert_allclose(plan.apply(ta, tb).numpy(), a @ b, **TOL)
    assert PHASE1_COUNTERS == before
    assert uploads == [], "apply copied host arrays to the device"


@pytest.mark.parametrize("dataflow", ["gust_m", "gust_n"])
def test_panel_apply_with_split_columns_makes_no_upload(dataflow,
                                                        monkeypatch):
    """A Gustavson plan whose long per-column chains K2 cuts into chunks:
    the column table and its chunk table are built and uploaded once, at
    plan time, and ``apply`` copies nothing."""
    a, b = _case(seed=6, m=16, k=8 * 16, n=16, da=1.0, db=1.0)
    monkeypatch.setattr(get_backend("cuda"), "dense_threshold", 2.0)
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend="cuda", device="cpu")
    assert "dense" not in plan.aux
    cols = plan.aux["device_schedule"].cols
    assert cols.n_split > 0 and cols.n_chunk > cols.n_seg == 4
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    before = dict(PHASE1_COUNTERS)
    uploads = []
    real_as_tensor = torch.as_tensor

    def counting_as_tensor(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            uploads.append(x.shape)
        return real_as_tensor(x, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting_as_tensor)
    for _ in range(2):
        np.testing.assert_allclose(plan.apply(ta, tb).numpy(), a @ b, **TOL)
    assert PHASE1_COUNTERS == before
    assert uploads == [], "apply copied host arrays to the device"
