"""``repro_torch.benchmarks`` against the repository's ``benchmarks``.

Every simulator section's rows (names and ``derived`` strings) equal the
JAX suite's row for row, except table8's ``fig17/kernel_substrate`` row,
which counts each package's own kernel source lines.  The kernels section
runs ``--quick`` on the CPU (every backend's plain versions): its rows
carry the JAX suite's names with the ``cuda`` backend in place of
``pallas``, and every apply lies within 1e-4 of fp64.  ``bench_compare``
passes a snapshot against itself and fails a regressed one.
"""
import importlib
import json
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))        # the JAX suite's ``benchmarks``

SECTIONS = ["fig1_best_dataflow", "fig12_end_to_end", "fig13_layerwise",
            "fig14_traffic", "table4_transitions", "table8_area",
            "fig18_perf_area"]
#: rows that describe their own package's source, not the simulator
OWN_SOURCE = {"fig17/kernel_substrate"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this module: the kernels section times
    single calls on 64 x 128 operands, and with several test workers on
    the machine's cores torch's thread pool stalls one call by tens of
    milliseconds."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("section", SECTIONS)
def test_simulator_section_matches_jax_suite(section):
    want = importlib.import_module(f"benchmarks.{section}").run()
    got = importlib.import_module(f"repro_torch.benchmarks.{section}").run()
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        if g.name not in OWN_SOURCE:
            assert g.derived == w.derived, g.name
    own = [g for g in got if g.name in OWN_SOURCE]
    for g in own:
        shared, per_df = map(int, re.findall(r"=(\d+)", g.derived))
        assert shared > per_df > 0


def test_kernels_quick_on_cpu():
    from repro_torch.benchmarks import kernels_bench

    rows = kernels_bench.run(quick=True, device="cpu")
    names = [r.name for r in rows]
    for backend in kernels_bench.BACKENDS:
        for leaf in ("ip_m", "op_m", "gust_m", "plan_build", "plan_verify",
                     "plan_apply", "per_call"):
            assert f"kernels/sq_like/{backend}/{leaf}" in names
    assert "kernels/sq_like/mixed_tiles" in names
    assert {f"kernels/sq_like/policy_{p}" for p in
            ("heuristic", "simulator", "learned")} <= set(names)
    errs = [float(m.group(1)) for r in rows
            for m in [re.search(r"max_err=([0-9.e+-]+)", r.derived)] if m]
    assert len(errs) == 8 and max(errs) <= 1e-4
    # on the CPU the cuda backend runs the kernels' plain versions
    apply_row = next(r for r in rows
                     if r.name == "kernels/sq_like/cuda/plan_apply")
    assert apply_row.extra["kernel_launches"] == 0
    assert apply_row.extra["device"] == "cpu"


def test_run_cli_prints_the_csv_contract(capsys):
    from repro_torch.benchmarks import run

    assert run.main(["fig13", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 1 + 10 and lines[-1].startswith("fig13/summary,")


def test_bench_compare_on_the_h100_snapshot(tmp_path):
    from repro_torch.benchmarks import bench_compare

    base = json.loads(Path(bench_compare.BASELINE).read_text())
    assert "H100" in base["device"]["name"]
    assert base["device"]["nvidia_smi"]
    rows = {r["name"]: r for r in base["rows"]}
    assert rows["kernels/sq_like/cuda/plan_apply"]["kernel_launches"] > 0
    bench_compare.main([bench_compare.BASELINE])        # no regression
    slow = dict(base, rows=[dict(r, us_per_call=r["us_per_call"] * 2)
                            for r in base["rows"]])
    path = tmp_path / "slow.json"
    path.write_text(json.dumps(slow))
    with pytest.raises(SystemExit) as exc:
        bench_compare.main([str(path)])
    assert exc.value.code == 1
