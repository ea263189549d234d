"""The port's analysis layer against the JAX package's.

``repro_torch.analysis.verify_plan`` must give the diagnostic codes and
severities that ``repro.analysis.verify_plan`` gives on the same plans:
clean plans of every family, and every mutation case of
``tests/test_analysis.py`` (build a legitimate plan through
``flexagon_plan`` on both sides, corrupt exactly one invariant the same
way, compare).  Then the port-only parts: the ``verify=`` gate,
``verify_cache``, the dispatch trace report (host syncs, kernel launches,
FLOPs, identity) and its ``RetraceDetector``, the AST lint pointed at
``src/repro_torch``, and the ``python -m repro_torch.analysis`` CLI.
Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import MemoryBudget as JaxBudget
from repro import PlanCache as JaxPlanCache
from repro import flexagon_plan as jax_flexagon_plan
from repro.analysis import verify_cache as jax_verify_cache
from repro.analysis import verify_plan as jax_verify_plan
from repro.core import random_sparse_dense

from repro_torch import MemoryBudget, PlanCache, flexagon_plan
from repro_torch.analysis import (ERROR, PlanDiagnostic,
                                  PlanVerificationError, RetraceDetector,
                                  errors_of, lint_paths, trace_report,
                                  verify_cache, verify_plan)
from repro_torch.core.dataflows import DATAFLOWS

ROOT = Path(__file__).resolve().parents[1]
BS = (16, 16, 16)
TILING = dict(l1_bytes=4096, l2_bytes=16384)


def _operands(m=64, k=64, n=64, da=0.4, db=0.4, seed=0):
    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


def _both(a, b, budget=False, jax_backend=None, backend=None, **kw):
    """The same plan built by both packages (port on the CPU)."""
    jkw, tkw = dict(kw), dict(kw)
    if budget:
        jkw["memory_budget"] = JaxBudget(**TILING)
        tkw["memory_budget"] = MemoryBudget(**TILING)
    jplan = jax_flexagon_plan(a, b, block_shape=BS, backend=jax_backend,
                              verify=False, **jkw)
    tplan = flexagon_plan(a, b, block_shape=BS, backend=backend,
                          device="cpu", verify=False, **tkw)
    return jplan, tplan


def _sig(diags):
    """Codes and severities, as a multiset."""
    return sorted((d.code, d.severity) for d in diags)


def _same(jdiags, tdiags):
    assert _sig(tdiags) == _sig(jdiags), ([str(d) for d in jdiags],
                                          [str(d) for d in tdiags])
    return {d.code for d in tdiags}


# ---------------------------------------------------------------------------
# clean plans: zero diagnostics across every family, as in JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backends", [(None, None), ("pallas", "cuda")],
                         ids=["reference", "cuda"])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_clean_untiled_plan_verifies(dataflow, backends):
    jplan, tplan = _both(*_operands(), dataflow=dataflow,
                         jax_backend=backends[0], backend=backends[1])
    assert _same(jax_verify_plan(jplan), verify_plan(tplan)) == set()


@pytest.mark.parametrize("dataflow", DATAFLOWS + ("mixed",))
def test_clean_tiled_plan_verifies(dataflow):
    jplan, tplan = _both(*_operands(), budget=True, dataflow=dataflow)
    assert _same(jax_verify_plan(jplan), verify_plan(tplan)) == set()


@pytest.mark.parametrize("dataflow", ("ip_m", "op_m", "gust_m"))
def test_clean_sharded_plan_verifies(dataflow, virtual_mesh):
    from repro_torch.launch.mesh import make_virtual_mesh

    a, b = _operands()
    jplan = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                              mesh=virtual_mesh, verify=False)
    tplan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                          mesh=make_virtual_mesh(8, "cpu"), verify=False)
    _same(jax_verify_plan(jplan), verify_plan(tplan))
    assert not errors_of(verify_plan(tplan))


def test_undersized_mesh_is_info():
    """Four shards on a two-device mesh: the serial path, reported as the
    JAX package reports it (``mesh-undersized``, INFO)."""
    from repro.dist import DistPartition as JaxPartition
    from repro.launch.mesh import make_virtual_mesh as jax_mesh

    from repro_torch import DistPartition
    from repro_torch.launch.mesh import make_virtual_mesh

    a, b = _operands()
    jplan = jax_flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                              mesh=jax_mesh(2),
                              partition=JaxPartition(shards=4), verify=False)
    tplan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                          mesh=make_virtual_mesh(2, "cpu"),
                          partition=DistPartition(shards=4), verify=False)
    assert _same(jax_verify_plan(jplan), verify_plan(tplan)) \
        == {"mesh-undersized"}


def test_clean_moe_plan_verifies():
    from repro.configs import get_config as jax_get_config
    from repro.models.moe import plan_moe as jax_plan_moe

    from repro_torch.configs import get_config
    from repro_torch.models.moe import plan_moe

    arch = "granite-moe-1b-a400m"
    jplan = jax_plan_moe(jax_get_config(arch, smoke=True), 4)
    tplan = plan_moe(get_config(arch, smoke=True), 4)
    assert tplan.strategy == jplan.strategy
    assert _same(jax_verify_plan(jplan), verify_plan(tplan)) == set()


def test_unknown_plan_type():
    assert _same(jax_verify_plan(object()), verify_plan(object())) \
        == {"unknown-plan-type"}


# ---------------------------------------------------------------------------
# mutations: each corrupted invariant is caught with JAX's code
# ---------------------------------------------------------------------------


def _pad_entry(plan, ci):
    """``plan`` with one pad work entry appended to its StreamPlan."""
    sp = plan.index_plan
    pad = lambda arr, v: np.append(np.asarray(arr), np.int32(v))  # noqa
    return dataclasses.replace(plan, index_plan=dataclasses.replace(
        sp, ci=pad(sp.ci, ci), cj=pad(sp.cj, 0), a_slot=pad(sp.a_slot, 0),
        b_slot=pad(sp.b_slot, 0)))


def _mut_fingerprint(plan):
    return dataclasses.replace(plan, fingerprint="0" * 16)


def _mut_format(plan):
    return dataclasses.replace(plan, a_layout=plan.b_layout)


def _mut_pad_inbounds(plan):
    return _pad_entry(plan, 0)


def _mut_pad_out_of_grid(plan):
    return _pad_entry(plan, -(-plan.shapes[0] // BS[0]))


def _mut_unknown_backend(plan):
    return dataclasses.replace(plan, backend="no-such-substrate")


MUTATIONS = {
    # name: (dataflow, budget, mutate)
    "fingerprint-mismatch": ("ip_m", False, _mut_fingerprint),
    "format-mismatch": ("ip_m", False, _mut_format),
    "pad-inbounds": ("gust_m", False, _mut_pad_inbounds),
    "pad-out-of-grid": ("gust_m", False, _mut_pad_out_of_grid),
    "backend-unknown": ("ip_m", False, _mut_unknown_backend),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_match_jax(name):
    """Each seeded corruption of ``tests/test_analysis.py`` gives the same
    codes and severities on both packages."""
    dataflow, budget, mutate = MUTATIONS[name]
    jplan, tplan = _both(*_operands(), budget=budget, dataflow=dataflow)
    tbad = mutate(tplan)
    codes = _same(jax_verify_plan(mutate(jplan)), verify_plan(tbad))
    if name == "pad-out-of-grid":
        assert "pad-inbounds" not in codes
    else:
        assert name in codes
        with pytest.raises(PlanVerificationError) as exc:
            verify_plan(tbad, raise_on_error=True)
        assert exc.value.diagnostics[0].is_error


def test_mutation_wrong_format_subplan():
    """The format corruption one level down, inside a TiledPlan's tile."""
    a, b = _operands()
    bad = []
    for fp, budget in ((jax_flexagon_plan, JaxBudget(**TILING)),
                       (flexagon_plan, MemoryBudget(**TILING))):
        dev = {} if fp is jax_flexagon_plan else {"device": "cpu"}
        plan = fp(a, b, dataflow="gust_m", block_shape=BS,
                  memory_budget=budget, verify=False, **dev)
        donor = fp(a, b, dataflow="ip_m", block_shape=BS, verify=False,
                   **dev)
        sub = dataclasses.replace(plan.plans[0], b_layout=donor.b_layout)
        bad.append(dataclasses.replace(
            plan, plans=(sub,) + tuple(plan.plans[1:])))
    codes = _same(jax_verify_plan(bad[0]), verify_plan(bad[1]))
    assert "format-mismatch" in codes
    assert any(d.location.startswith("plan.plans[0]")
               for d in verify_plan(bad[1]))


def test_mutation_overlapping_tiles():
    jplan, tplan = _both(*_operands(), budget=True, dataflow="ip_m")
    assert len(tplan.tiles) >= 2, "budget must force tiling for this test"
    bads = [dataclasses.replace(p, tiles=(p.tiles[0], p.tiles[0])
                                + p.tiles[2:]) for p in (jplan, tplan)]
    codes = _same(jax_verify_plan(bads[0]), verify_plan(bads[1]))
    assert {"tile-overlap", "tile-gap"} <= codes


def test_mutation_scan_plan_on_non_streaming_backend(monkeypatch):
    """A plan of padded OP slab lanes pointed at a backend that does not
    declare ``scan_streaming``: ``backend-capability`` on both sides, and
    ``with_backend`` rebuilds a clean plan."""
    from repro.backends import base as jax_base
    from repro.backends.reference import ReferenceBackend as JaxReference

    from repro_torch.backends import base
    from repro_torch.backends.reference import ReferenceBackend

    class JaxNoScan(JaxReference):
        name = "test-no-scan"
        scan_streaming = False

    class NoScan(ReferenceBackend):
        name = "test-no-scan"
        scan_streaming = False

    monkeypatch.setitem(jax_base._REGISTRY, "test-no-scan", JaxNoScan())
    monkeypatch.setitem(base._REGISTRY, "test-no-scan", NoScan())
    jplan, tplan = _both(*_operands(), budget=True, dataflow="op_m",
                         jax_backend="reference", backend="reference")
    assert tplan.scan_ok
    bads = [dataclasses.replace(p, backend="test-no-scan")
            for p in (jplan, tplan)]
    assert "backend-capability" in _same(jax_verify_plan(bads[0]),
                                         verify_plan(bads[1]))
    assert not errors_of(verify_plan(tplan.with_backend("test-no-scan")))
    assert not errors_of(verify_plan(tplan.with_backend("cuda")))


def test_collective_plan_off_its_mesh_device(monkeypatch, tmp_path):
    """The port's counterpart of JAX's ``collective_merge`` check: a plan
    on the collective path must live on the device kind of its mesh's
    ranks.  One gloo rank on a cpu ``DeviceMesh``, with the path forced to
    "collective" (it needs a rank per shard)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import DistPartition, ShardedPlan

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
        a, b = _operands()
        plan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                             mesh=mesh, partition=DistPartition(shards=2),
                             verify=False)
        assert plan.path == "serial"
        assert _sig(verify_plan(plan)) == [("mesh-undersized", "info")]
        monkeypatch.setattr(ShardedPlan, "path",
                            property(lambda self: "collective"))
        assert not errors_of(verify_plan(plan))
        moved = dataclasses.replace(plan, device=torch.device("meta"))
        assert [d.code for d in errors_of(verify_plan(moved))] \
            == ["backend-capability"]
    finally:
        dist.destroy_process_group()


def test_mutation_moe_plan():
    from repro.models.moe import MoEPlan as JaxMoEPlan

    from repro_torch.models.moe import MoEPlan

    for kw, code in ((dict(strategy="auto", tokens=4),
                      "moe-strategy-invalid"),
                     (dict(strategy="einsum", tokens=0),
                      "moe-tokens-invalid")):
        assert code in _same(jax_verify_plan(JaxMoEPlan(**kw)),
                             verify_plan(MoEPlan(**kw)))


def test_verify_gate_in_flexagon_plan():
    a, b = _operands()
    plan = flexagon_plan(a, b, dataflow="gust_m", block_shape=BS,
                         device="cpu", verify=True)
    assert plan.dataflow == "gust_m"
    cache = PlanCache()
    cache.get(a, b, block_shape=BS, device="cpu", verify=True)
    assert cache.stats["misses"] == 1


def test_verify_cache_key_mismatch():
    a, b = _operands()
    caches = []
    for cache, dev in ((JaxPlanCache(), {}), (PlanCache(), {"device": "cpu"})):
        plan = cache.get(a, b, block_shape=BS, **dev)
        key = next(iter(cache._plans))
        cache._plans[key] = dataclasses.replace(plan, fingerprint="f" * 16)
        caches.append(cache)
    codes = _same(jax_verify_cache(caches[0]), verify_cache(caches[1]))
    assert {"cache-key-mismatch", "fingerprint-mismatch"} <= codes


def test_verify_leaves_phase1_counters_alone():
    from repro_torch import PHASE1_COUNTERS

    a, b = _operands()
    plan = flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu",
                         memory_budget=MemoryBudget(**TILING),
                         dataflow="mixed", verify=False)
    before = dict(PHASE1_COUNTERS)
    assert verify_plan(plan) == []
    assert dict(PHASE1_COUNTERS) == before


# ---------------------------------------------------------------------------
# dispatch trace report: host syncs, launches, FLOPs, identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_trace_report_pure_and_deterministic(dataflow, backend):
    a, b = _operands()
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend=backend, device="cpu")
    rep1, rep2 = trace_report(plan), trace_report(plan)
    assert rep1.pure and rep1.host_syncs == {}
    assert rep1.n_ops > 0 and rep1.flops > 0
    assert rep1.op_hash == rep2.op_hash
    # the plain versions run on the CPU: no kernel launches to count
    assert set(rep1.launches.values()) == {0}
    assert not errors_of(rep1.diagnostics)


@pytest.mark.parametrize("kw", [
    dict(dataflow="gust_m", memory_budget=MemoryBudget(**TILING)),
    dict(dataflow="mixed", memory_budget=MemoryBudget(**TILING)),
    dict(dataflow="op_m", partition="2"),
], ids=["tiled", "mixed", "sharded"])
def test_trace_report_composed_plans_pure(kw):
    from repro_torch import DistPartition

    if kw.get("partition"):
        kw = dict(kw, partition=DistPartition(shards=2))
    a, b = _operands()
    plan = flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu",
                         **kw)
    rep = trace_report(plan)
    assert rep.pure and rep.flops > 0
    assert rep.op_hash == trace_report(plan).op_hash


def test_trace_report_flops_match_the_schedule():
    """FLOPs are 2·bm·bk·bn per real work entry, summed over tiles; the
    estimate's pricing stays within the 2x warning band here."""
    a, b = _operands()
    plan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                         backend="cuda", device="cpu")
    rep = trace_report(plan)
    work = plan.aux["stream_schedule"].n_real_work
    assert rep.flops == 2.0 * 16 ** 3 * work
    assert not [d for d in rep.diagnostics
                if d.code == "traffic-disagreement"]
    tiled = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                          backend="cuda", device="cpu",
                          memory_budget=MemoryBudget(**TILING))
    assert trace_report(tiled).flops == sum(
        2.0 * 16 ** 3 * p.aux["stream_schedule"].n_real_work
        for p in tiled.plans)


def test_trace_report_flags_host_syncs_and_disagreement():
    """A plan whose apply reads a value into Python syncs the host; a plan
    whose estimate is 10x off its schedule draws the warning."""
    a, b = _operands()
    plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                         backend="cuda", device="cpu")

    class Syncing:
        shapes, device, fingerprint = plan.shapes, plan.device, "x"
        aux, plans, estimate = plan.aux, (plan,), plan.estimate

        def apply(self, x, y, out_dtype=torch.float32):
            out = plan.apply(x, y, out_dtype)
            if float(out.abs().max()) >= 0:     # reads a value: a sync
                return out
            return out

    rep = trace_report(Syncing())
    assert not rep.pure
    assert "aten::_local_scalar_dense" in rep.host_syncs
    assert [d.code for d in errors_of(rep.diagnostics)] == ["host-sync"]
    off = dataclasses.replace(plan, estimate=dataclasses.replace(
        plan.estimate, flops=plan.estimate.flops * 10))
    assert "traffic-disagreement" in {
        d.code for d in trace_report(off).diagnostics}


def test_sync_rules_for_device_tensors():
    """What waits for a card: device-to-host copies, and data-dependent
    shapes or boolean masks on a device (``meta`` stands in for a card
    here); the same operators on the CPU do not."""
    from repro_torch.analysis.dispatch import _sync_kind

    dev, host = torch.zeros(4, device="meta"), torch.zeros(4)
    mask = torch.zeros(4, dtype=torch.bool, device="meta")
    assert _sync_kind("aten::_to_copy", (dev,), {}, [host]) \
        == "device-to-host copy"
    assert _sync_kind("aten::_to_copy", (host,), {}, [dev]) is None
    assert _sync_kind("aten::nonzero", (dev,), {}, []) == "aten::nonzero"
    assert _sync_kind("aten::nonzero", (host,), {}, []) is None
    assert _sync_kind("aten::index", (dev, [mask]), {}, []) \
        == "aten::index (boolean mask)"
    assert _sync_kind("aten::repeat_interleave", (dev,), {}, []) \
        == "aten::repeat_interleave"
    assert _sync_kind("aten::repeat_interleave", (dev,),
                      {"output_size": 8}, []) is None
    assert _sync_kind("aten::_local_scalar_dense", (host,), {}, []) \
        == "aten::_local_scalar_dense"


def test_retrace_detector_stable_across_cache_hits():
    a, b = _operands()
    cache = PlanCache()
    det = RetraceDetector()
    for _ in range(3):
        det.observe(cache.get(a, b, block_shape=BS, backend="cuda",
                              device="cpu"))
    assert det.stable and det.retraces == []
    assert cache.stats["hits"] == 2


def test_retrace_detector_catches_a_changed_program():
    a, b = _operands()
    det = RetraceDetector()
    plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                         backend="cuda", device="cpu")
    det.observe(plan)
    # same identity, another program: the reference executors
    det.observe(dataclasses.replace(plan, aux=plan.with_backend(
        "reference").aux, backend="reference"))
    assert det.stable
    det.observe(dataclasses.replace(plan, aux={**plan.aux, "dense": ()}))
    assert not det.stable and det.retraces[0].retraced


# ---------------------------------------------------------------------------
# AST lint, pointed at the port
# ---------------------------------------------------------------------------

_BAD_MODULE = '''
import ctypes
import dataclasses
import time

import numpy as np


def _helper(x):
    return np.asarray(x).sum()


def apply(x):
    return _helper(x)


def launch(lib, x):
    return lib.flexagon_stream_spmm(x)


def schedule(a):
    return StreamSchedule(a, a, a, a, a, a, a, a, 4)


def upload(a):
    return DeviceSchedule(a)


def clock():
    return time.perf_counter()


def tick(self):
    self.stats["hits"] += 1


@dataclasses.dataclass
class CustomPlan:
    dataflow: str
'''


def _port_file(tmp_path, rel, text):
    f = tmp_path / "repro_torch" / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(text)
    return str(f)


def test_lint_catches_all_rule_violations(tmp_path):
    bad = _port_file(tmp_path, "subsys/bad.py", _BAD_MODULE)
    codes = Counter(d.code for d in lint_paths([bad]))
    assert codes == {"host-np": 1, "kernel-call": 2, "schedule-call": 2,
                     "obs-time": 1, "obs-stats": 1, "plan-frozen": 1}
    assert all(d.is_error for d in lint_paths([bad])
               if d.code != "obs-stats")


def test_lint_scopes_and_pragmas(tmp_path):
    # the kernel library may bind ctypes and build schedules
    ok = _port_file(tmp_path, "kernels/k.py",
                    "import ctypes\n\n\n"
                    "def run(lib, a):\n"
                    "    lib.flexagon_gmm(a)\n"
                    "    return StreamSchedule(a, a, a, a, a, a, a, a, 1)\n")
    assert lint_paths([ok]) == []
    # the obs layer is the clock
    clock = _port_file(tmp_path, "obs/trace.py",
                       "import time\nnow = time.perf_counter_ns()\n")
    assert lint_paths([clock]) == []
    # pragmas: host-ok cuts the edge, time-ok and stats-ok the line
    prag = _port_file(tmp_path, "subsys/ok.py",
                      "import time\nimport numpy as np\n\n\n"
                      "def _host(x):\n"
                      "    return np.asarray(x)\n\n\n"
                      "def apply(x):\n"
                      "    return _host(x)  # lint: host-ok (fast path)\n\n\n"
                      "def measure(self):\n"
                      "    self.stats['n'] += 1  # lint: stats-ok\n"
                      "    return time.perf_counter()  # lint: time-ok\n")
    assert lint_paths([prag]) == []
    # outside repro_torch/ the scoped rules never fire
    outside = tmp_path / "bench.py"
    outside.write_text("import ctypes\nimport time\nt = time.time()\n")
    assert lint_paths([str(outside)]) == []


def test_lint_clean_on_shipped_tree():
    """The port's tree lints clean with its own rules."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         str(ROOT / "src" / "repro_torch")],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_diagnostic_shapes():
    d = PlanDiagnostic(code="x", severity=ERROR, message="m", location="l",
                       hint="h")
    assert d.is_error and "x" in str(d) and "l" in str(d)
    with pytest.raises(dataclasses.FrozenInstanceError):
        d.code = "y"
    with pytest.raises(ValueError):
        PlanDiagnostic(code="x", severity="fatal", message="m")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(*argv, module="repro_torch.analysis"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_VERIFY="0")
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True)


def test_unified_cli():
    usage = _cli()
    assert usage.returncode == 2 and "subcommands" in usage.stdout
    assert _cli("frobnicate").returncode == 2
    lint = _cli("lint", "src/repro_torch/analysis")
    assert lint.returncode == 0, lint.stdout + lint.stderr
    for cmd in ("verify", "trace", "schedule"):
        proc = _cli(cmd, "--device", "cpu")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 error(s)" in proc.stdout


def test_obs_cli_demo_export_validate(tmp_path):
    trace = str(tmp_path / "trace.jsonl")
    demo = _cli("demo", "--device", "cpu", "--steps", "2", "--out", trace,
                module="repro_torch.obs")
    assert demo.returncode == 0, demo.stdout + demo.stderr
    chrome = str(tmp_path / "trace.chrome.json")
    assert _cli("export", trace, "--out", chrome,
                module="repro_torch.obs").returncode == 0
    assert _cli("validate", chrome, module="repro_torch.obs").returncode == 0
    summary = _cli("summarize", trace, module="repro_torch.obs")
    assert "memory.tiled.apply" in summary.stdout
    assert "plan.phase1" in _cli("dump", trace,
                                 module="repro_torch.obs").stdout
