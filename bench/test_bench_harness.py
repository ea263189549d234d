"""CPU tests of the benchmark: pieces found by name, the contract's form,
the work count, the reference, the frozen tables and the imports."""
import ast
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness, reference, tracing, work

HERE = Path(__file__).resolve().parent
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny_config():
    """Three small products with edges that hang over the blocks."""
    return {"name": "tiny", "driver": "layer_products", "block": 32,
            "layers": [["T0", 64, 40, 96, 50.0, 40.0],
                       ["T1", 96, 24, 70, 0.0, 0.0],
                       ["T2", 130, 64, 64, 85.0, 30.0]],
            "limits": {"max_rel_err": 1e-4}}


def tiny_traffic():
    return {"samples_per_step": 2, "in_flight": 2, "value_sets": 2,
            "warm_steps": 2, "trace_steps": 2, "check": {"sample_below": 4}}


def run_tiny(seed=5):
    return harness.run(SPEC, "distilbert.b64", seed, 0.3, 0, "cpu",
                       time.perf_counter(), cfg=tiny_config(),
                       traffic=tiny_traffic())


CELLS = [c["name"] for c in SPEC["workloads"]]
#: the per-layer metrics of the two accepted cells
ACCEPTED = ("plan_s", "apply_host_us", "launches_per_step", "k1_ms_per_step",
            "k2_ms_per_step", "spmm_roofline", "step_mfu", "idle_share",
            "plan_pattern_s", "plan_select_s", "plan_tables_s",
            "plan_prepare_s", "apply_us", "ingest_ms_per_step",
            "dispatch_ms_per_step", "escape_ms_per_step", "host_idle_share")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_pieces(spec, cell_name, root=harness.ROOT):
    """The cell's pieces are found by name in the checkout at ``root``,
    and its per-layer metrics are those whose ``workloads`` name it."""
    cell = harness.cell_of(spec, cell_name)
    cfg = harness.config_of(spec, cell, root)
    assert harness.driver_of(cfg, root).Run
    assert harness.traffic_of(cell["traffic"], root)
    assert cfg["limits"] and all(isinstance(v, (int, float))
                                 for v in cfg["limits"].values())
    for t in (0, 1):
        for m in harness.metrics_of(spec, cell_name, t):
            assert callable(harness.reader_of(m["name"], root))
    assert {m["name"] for m in harness.metrics_of(spec, cell_name, 1)} == {
        m["name"] for m in spec["per_layer"] if cell_name in m["workloads"]}
    assert harness.metrics_of(spec, cell_name, 0) == [
        m for m in spec["end_to_end"]
        if cell_name in m.get("workloads", [cell_name])]


def check_contract_form(spec):
    """What the contract asks of ``BENCHMARK.json``'s form."""
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and 1 <= spec["run_seconds"] <= 51
    cells = {c["name"] for c in spec["workloads"]}
    names = [x["name"] for x in itertools.chain(
        spec["configs"], spec["workloads"], spec["end_to_end"],
        spec["per_layer"])]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and len(c["source"]) <= 200
        assert c["name"] in used
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(spec["workloads"]) // 4)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        # each per-layer metric names its cells, and each of them reports
        # the end-to-end metric it moves
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.metrics_of(
                spec, cell, 0)}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in cells:
        assert harness.metrics_of(spec, cell, 1)


def check_accepted(spec):
    """The accepted cells' metrics, pinned by name: facts about those
    metrics, not about every metric a later cell adds."""
    per = {m["name"]: m for m in spec["per_layer"]}
    assert set(ACCEPTED) <= set(per)

    def reads(cell):
        return {m["name"] for m in harness.metrics_of(spec, cell, 1)} & set(
            ACCEPTED)

    assert reads("distilbert.b64") == set(ACCEPTED) - {"k2_ms_per_step"}
    assert reads("resnet50.b128") == set(ACCEPTED) - {"escape_ms_per_step"}
    assert per["k2_ms_per_step"]["workloads"] == ["resnet50.b128"]
    assert per["escape_ms_per_step"]["workloads"] == ["distilbert.b64"]
    for name in ("distilbert.b64", "resnet50.b128"):
        cell = harness.cell_of(spec, name)
        assert cell["chips"] == 1
        assert "max_rel_err" in harness.config_of(spec, cell)["limits"]
        assert harness.traffic_of(cell["traffic"])["samples_per_step"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_pieces_found_by_name(cell):
    check_pieces(SPEC, cell)


def test_accepted_cells_keep_their_metrics():
    check_accepted(SPEC)


def test_spec_keeps_the_contract_form():
    check_contract_form(SPEC)


def test_block_pattern_places_exactly_its_blocks():
    a = work.block_pattern(np.random.default_rng(3), (100, 70), 32, 0.4)
    b = work.block_pattern(np.random.default_rng(3), (100, 70), 32, 0.4)
    assert a.shape == (4, 3) and a.sum() == round(0.4 * 12)
    assert np.array_equal(a, b)
    assert work.block_pattern(np.random.default_rng(0), (5, 5), 32,
                              0.01).sum() == 1


@pytest.mark.parametrize("shape", [(64, 64, 64), (70, 45, 100), (33, 96, 1)])
def test_product_work_against_brute_force(shape):
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    occ_a = work.block_pattern(rng, (m, k), 32, 0.5)
    occ_b = work.block_pattern(rng, (k, n), 32, 0.6)
    flops = nbytes = 0
    ext = lambda i, total: min(32, total - 32 * i)   # noqa: E731
    for i, kk, j in itertools.product(range(occ_a.shape[0]),
                                      range(occ_a.shape[1]),
                                      range(occ_b.shape[1])):
        if occ_a[i, kk] and occ_b[kk, j]:
            flops += 2 * ext(i, m) * ext(kk, k) * ext(j, n)
    for (i, kk) in zip(*np.nonzero(occ_a)):
        nbytes += 4 * ext(i, m) * ext(kk, k)
    for (kk, j) in zip(*np.nonzero(occ_b)):
        nbytes += 4 * ext(kk, k) * ext(j, n)
    nbytes += 4 * m * n
    assert work.product_work(occ_a, occ_b, shape, 32) == (flops, nbytes)


def test_bound_and_peaks():
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks["fp32_flop_per_s"] == 67e12
    assert peaks["bf16_flop_per_s"] == 989.4e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert work.bound_s(67e12, 0, peaks) == 1.0
    assert work.bound_s(0, 6.7e12, peaks) == 2.0
    assert work.peaks_for("cpu") is None


def test_reference_against_numpy():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((37, 50)).astype(np.float32)
    b = rng.standard_normal((50, 29)).astype(np.float32)
    got = reference.product(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_rel_err():
    ref = torch.tensor([[2.0, -4.0]], dtype=torch.float64)
    assert reference.rel_err(torch.tensor([[2.0, -3.0]]), ref) == 0.25
    assert reference.rel_err(torch.zeros(1, 2), torch.zeros(
        1, 2, dtype=torch.float64)) == 0.0


@pytest.mark.parametrize("model,layers", [("distilbert", 36),
                                          ("resnet50", 54)])
def test_frozen_tables(model, layers):
    from repro_torch.core.workloads import MODELS, PAPER_LAYERS, model_layers

    cfg = json.loads((HERE / "configs" / f"{model}.json").read_text())
    assert len(cfg["layers"]) == layers == MODELS[model].nl
    assert cfg["block"] == 32 and cfg["dtype"] == "float32"
    for row, spec in zip(cfg["layers"], model_layers(model, seed=0)):
        assert row[:4] == [spec.name, spec.m, spec.n, spec.k]
        assert row[4] == pytest.approx(spec.sp_a, abs=1e-6)
        # DistilBERT's B keeps Table 2's average in every layer: the
        # jitter around 0.04, clipped at 0, would average 3.3%
        want_b = (cfg["table2"]["av_sp_b"] if model == "distilbert"
                  else spec.sp_b)
        assert row[5] == pytest.approx(want_b, abs=1e-6)
    if model == "resnet50":
        for i, name in ((4, "R4"), (6, "R6")):
            p = PAPER_LAYERS[name]
            assert cfg["layers"][i] == [name, p.m, p.n, p.k, p.sp_a, p.sp_b]


@pytest.mark.parametrize("model", ["distilbert", "resnet50"])
@pytest.mark.parametrize("column", ["sp_a", "sp_b"])
def test_table_means_match_table2(model, column):
    """Each frozen table's mean sparsity lies within 5% of Table 2's
    average for its model."""
    cfg = json.loads((HERE / "configs" / f"{model}.json").read_text())
    at = cfg["columns"].index(column)
    mean = float(np.mean([row[at] for row in cfg["layers"]]))
    assert mean == pytest.approx(cfg["table2"][f"av_{column}"], rel=0.05)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_imports():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.JAX_NAMES, (path, name)
    for name in ("reference.py", "work.py"):
        tops = {n.split(".")[0] for n in _imports(HERE / name)}
        assert tops <= {"__future__", "json", "pathlib", "numpy", "torch"}


def test_tracing_reduce():
    """One step of three ops: the gaps are named by the op before them."""
    device = [("stream_dest_kernel", 100.0, 300.0),
              ("Memset", 300.0, 350.0),
              ("stream_panel_kernel", 500.0, 600.0),
              ("Memset", 650.0, 660.0)]
    got = tracing.reduce(device, steps=1)
    assert got["window_s"] == pytest.approx(560e-6)
    assert got["busy_s"] == pytest.approx(360e-6)
    assert got["ops"]["stream_dest_kernel"] == pytest.approx(200e-6)
    assert got["device_s"] == pytest.approx(360e-6)
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"after Memset": 150e-6, "after stream_panel_kernel": 50e-6})
    assert got["idle_by_step"] == pytest.approx([200e-6])
    assert tracing.reduce([], steps=1) is None


def test_tracing_drops_the_first_steps():
    """Three steps of two ops each, the first after a long stall: with
    one step skipped the window starts at the second step."""
    device = [("k", 0.0, 10.0), ("m", 10.0, 12.0),
              ("k", 500.0, 510.0), ("m", 510.0, 512.0),
              ("k", 515.0, 525.0), ("m", 525.0, 527.0)]
    got = tracing.reduce(device, steps=2, skip=1)
    assert got["window_s"] == pytest.approx(27e-6)
    assert got["busy_s"] == pytest.approx(24e-6)
    assert got["ops"] == pytest.approx({"k": 20e-6, "m": 4e-6})
    assert got["idle_by_step"] == pytest.approx([3e-6, 0.0])
    assert tracing.short_name(
        "void stream_dest_kernel<2>(Walk)") == "stream_dest_kernel"


def test_tracing_refuses_a_trace_that_lost_operations():
    """Where the ops do not divide into the traced steps, the first steps
    cannot be dropped: no reading, rather than one with the stall in."""
    device = [("k", 0.0, 10.0), ("m", 10.0, 12.0),
              ("k", 500.0, 510.0), ("m", 510.0, 512.0),
              ("k", 515.0, 525.0)]
    assert tracing.reduce(device, steps=2, skip=1) is None


def _ctx(**kw):
    from types import SimpleNamespace

    base = dict(setup_s=30.0, plan_s=9.0, steps=100, samples=6400,
                window_s=10.0, step_ms=[float(i) for i in range(1, 101)],
                apply_s=0.5, applies=3600, launches=2200,
                flops_per_step=3.35e11, bound_s_per_step=5e-3,
                peaks=work.peaks_for("H100"),
                trace={"steps": 16, "ops": {"stream_dest_kernel": 0.08,
                                            "stream_reduce_kernel": 0.016},
                       "device_s": 0.32, "busy_s": 0.3, "window_s": 0.4})
    base.update(kw)
    return SimpleNamespace(**base)


def test_metric_readers():
    read = {m["name"]: harness.reader_of(m["name"])
            for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    ctx = _ctx()
    assert read["samples_per_s"](ctx) == 640.0
    assert read["step_ms_p95"](ctx) == 95.0
    assert read["apply_host_us"](ctx) == pytest.approx(138.8888889)
    assert read["launches_per_step"](ctx) == 22.0
    assert read["k1_ms_per_step"](ctx) == pytest.approx(6.0)
    assert read["k2_ms_per_step"](ctx) is None
    assert read["spmm_roofline"](ctx) == pytest.approx(25.0)
    assert read["step_mfu"](ctx) == pytest.approx(5.0)
    assert read["idle_share"](ctx) == pytest.approx(25.0)
    bare = _ctx(trace=None)
    for name in ("k1_ms_per_step", "spmm_roofline", "idle_share"):
        assert read[name](bare) is None


def test_sound_run_is_correct_on_cpu():
    result, lines = run_tiny()
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "samples_per_s",
                                      "step_ms_p95"}
    assert list(result)[-1] == "checks"
    assert result["checks"]["max_rel_err"]["value"] < 1e-5
    assert lines[-1].startswith("max_rel_err ")


def test_run_refuses_without_a_card(tmp_path):
    """No card (or, in a directory holding only the benchmark, no
    program): a non-zero exit and no result."""
    import shutil

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    shutil.copytree(HERE, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    for root in (HERE.parent, tmp_path):
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", "resnet50.b128",
             "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""


def test_setup_is_the_same_work_for_every_seed():
    from bench.drivers import layer_products

    cfg, traffic = tiny_config(), tiny_traffic()
    one = layer_products.make_layers(cfg, traffic, 2 ** 31 + 7, "cpu")
    two = layer_products.make_layers(cfg, traffic, 2 ** 31 + 7, "cpu")
    other = layer_products.make_layers(cfg, traffic, 9, "cpu")
    for x, y, z in zip(one, two, other):
        assert torch.equal(x.a, y.a) and torch.equal(x.b_sets[1],
                                                      y.b_sets[1])
        assert x.occ_a.sum() == z.occ_a.sum()
        assert x.occ_b.sum() == z.occ_b.sum()
        assert not torch.equal(x.b_sets[0], x.b_sets[1])
        dense = x.b_sets[0].abs() > 0
        assert math.isclose(float(dense.float().mean()),
                            float((x.b_sets[1].abs() > 0).float().mean()))


def test_readers_given_none_return_none():
    """A driver without the plan API's notions hands the readers None."""
    ctx = _ctx(plan_s=None, flops_per_step=None, bound_s_per_step=None)
    for name in ("plan_s", "spmm_roofline", "step_mfu"):
        assert harness.reader_of(name)(ctx) is None


#: a second driver, as a later cell would add it: new files only
TOY_DRIVER = '''"""A toy driver: each step sums the rows of a seeded matrix."""
import time

import torch


class Run:
    def __init__(self, cfg, traffic, seed, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % 2 ** 63)
        self.rows, self.short = traffic["rows"], cfg["short"]
        self.x = torch.randn(self.rows, cfg["width"], generator=gen,
                             device=device)
        self.kept = {}

    def window(self, seconds):
        step_ms, steps, t0 = [], 0, time.perf_counter()
        while steps < 2 or time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            self.kept[steps % 2] = self.x[:self.rows - self.short].sum(1)
            step_ms.append((time.perf_counter() - t) * 1e3)
            steps += 1
        return {"steps": steps, "samples": steps * self.rows,
                "window_s": time.perf_counter() - t0, "step_ms": step_ms}

    def trace(self):
        return None

    def free_program(self):
        pass

    def check(self):
        ref = self.x.double().sum(1)
        per = {j: {"rows_short": float(self.rows - out.numel()),
                   "max_abs_err": float((out.double()
                                         - ref[:out.numel()]).abs().max())}
               for j, out in self.kept.items()}
        worst = {n: max(p[n] for p in per.values()) for n in
                 ("max_abs_err", "rows_short")}
        return worst, "the row sums", per
'''
TOY_METRIC = '''"""toy_rows_per_step: rows a step sums, read from the run."""


def read(ctx):
    ctx.breakdown = {"device_ops": [["toy/sum", 1e-3]], "idle_gaps": []}
    return ctx.run.rows
'''


@pytest.fixture
def toy_checkout(tmp_path):
    """A checkout of the benchmark with a cell of a second driver added as
    new files: a driver, its configuration, its traffic and a per-layer
    metric that names only its cell; returns (root, spec)."""
    import copy
    import shutil

    shutil.copytree(HERE, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "bench"
    (bench / "drivers" / "toy_rows.py").write_text(TOY_DRIVER)
    (bench / "metrics" / "toy_rows_per_step.py").write_text(TOY_METRIC)
    (bench / "traffic" / "t8.json").write_text(json.dumps({"rows": 8}))
    (bench / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "driver": "toy_rows", "width": 16, "short": 0,
         "limits": {"max_abs_err": 1e-4, "rows_short": 0}}))
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": "toy", "source": "https://example.org",
                            "file": "bench/configs/toy.json", "reduced": [],
                            "why": "a second driver"})
    spec["workloads"].append({"name": "toy.t8", "config": "toy",
                              "traffic": "t8", "chips": 1,
                              "why": "8 rows a step"})
    spec["per_layer"].append({"name": "toy_rows_per_step", "unit": "rows",
                              "better": "higher",
                              "source": "program_counter", "layer": "toy",
                              "moves": "samples_per_s",
                              "workloads": ["toy.t8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, harness.load_spec(tmp_path)


def test_a_second_driver_joins_as_new_files(toy_checkout):
    root, spec = toy_checkout
    toy = spec["per_layer"][-1]
    assert harness.metrics_of(spec, "toy.t8", 1) == [toy]
    assert harness.metrics_of(spec, "toy.t8", 0) == spec["end_to_end"]
    check_contract_form(spec)
    for cell in spec["workloads"]:
        check_pieces(spec, cell["name"], root)
    check_accepted(spec)
    for cell in CELLS:
        for t in (0, 1):
            assert harness.metrics_of(spec, cell, t) == harness.metrics_of(
                SPEC, cell, t)
    for t, names in ((0, {"setup_s", "samples_per_s", "step_ms_p95"}),
                     (1, {"toy_rows_per_step"})):
        result, lines = harness.run(spec, "toy.t8", 2 ** 31 + 13, 0.05, t,
                                    "cpu", time.perf_counter(), root=root)
        assert result["correct"] and result["failed"] == 0, lines
        assert set(result["metrics"]) == names
        assert list(result)[-1] == "checks"
        assert result["checks"]["rows_short"] == {"value": 0.0, "limit": 0}
        assert result["checks"]["max_abs_err"]["value"] < 1e-4
        assert lines[-2].startswith("max_abs_err ")
        assert lines[-1] == "rows_short 0.0 limit 0"
    # the reader had the run, and the breakdown it left is the result's
    assert result["metrics"]["toy_rows_per_step"]["value"] == 8
    assert result["breakdown"] == {"device_ops": [["toy/sum", 1e-3]],
                                   "idle_gaps": []}


def test_a_second_drivers_check_fails_a_broken_run(toy_checkout):
    """One of the driver's two numbers over its limit: not correct, and
    every checked step failed."""
    root, spec = toy_checkout
    cfg = json.loads((root / "bench" / "configs" / "toy.json").read_text())
    result, lines = harness.run(spec, "toy.t8", 7, 0.05, 0, "cpu",
                                time.perf_counter(), cfg=dict(cfg, short=1),
                                root=root)
    assert not result["correct"] and result["failed"] == 2
    assert result["checks"]["rows_short"] == {"value": 1.0, "limit": 0}
    assert result["checks"]["max_abs_err"]["value"] < 1e-4
    assert lines[-1] == "rows_short 1.0 limit 0"
