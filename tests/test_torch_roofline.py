"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``.

- ``active_params`` and ``model_flops`` equal the reference's on every arch
  and shape (the port matches expert leaves by name and rank where JAX
  matches its stacked paths);
- the FLOPs :class:`repro_torch.launch.dryrun.CostMode` counts for each
  arch's smoke-config loss (forward, batch 2 x 32, meta tensors, no mesh)
  against XLA's ``cost_analysis`` of the same function with every scan
  unrolled on one device (the reference's probe method).  XLA counts
  elementwise FLOPs as well, and the port counts products only
  (``torch.utils.flop_counter``): measured port/XLA ratios 0.80 (jamba)
  to 0.94 on this tree, so the band is [RATIO_LO, 1.0].
- ``analyze_cell`` takes its counts from the dry-run's artifact, and counts
  the cell itself, to the same record, where no artifact holds it.
"""
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.models import scan_config

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.selector import DeviceSpec
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import CostMode
from repro_torch.launch.specs import meta_model_init
from repro_torch.models import build_model


def _jax_roofline():
    """The reference module; its import asks for 512 virtual devices
    (through ``repro.launch.dryrun``), which must not reach this session's
    backend: the flag is put back before JAX reads it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.roofline as jr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jr


RATIO_LO = 0.75
B, S = 2, 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch):
    jr = _jax_roofline()
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.active_params(cfg) == jr.active_params(jcfg)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == jr.model_flops(
            jcfg, JAX_SHAPES[name]), name


def test_terms_use_the_hopper_spec():
    spec = DeviceSpec()
    assert roofline.SPEC == spec
    assert (spec.peak_flops, spec.hbm_bw, spec.ici_bw) == (989e12, 3.35e12,
                                                           450e9)
    assert roofline.CHIPS == 256
    assert all("MXU" not in h for h in roofline.HINTS.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counted_flops_against_xla_unrolled_probe(arch):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jm = jax_build_model(jcfg)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    jbatch = {"tokens": tok, "targets": tok}
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    if cfg.frontend == "frames":
        jbatch["frames"] = jax.ShapeDtypeStruct((B, S // 4, jcfg.d_model),
                                                jnp.bfloat16)
        batch["frames"] = torch.empty((B, S // 4, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    with scan_config.unrolled():
        cost = jax.jit(lambda p, b: jm.loss(p, b)[0]).lower(
            params, jbatch).compile().cost_analysis()
    xla = float(cost["flops"])
    mode = CostMode()
    with mode, torch.no_grad():
        build_model(cfg, device="meta").loss(
            meta_model_init(cfg, lambda m: m.init(0)), batch)
    ratio = mode.flops / xla
    assert RATIO_LO <= ratio <= 1.0, (arch, mode.flops, xla, ratio)
    # every counted FLOP is a product's
    assert set(mode.flops_by_op) <= {"aten.mm", "aten.bmm", "aten.addmm",
                                     "aten.baddbmm"}


def test_analyze_cell_reads_the_dryrun_record(tmp_path):
    from repro_torch.launch import dryrun

    cell = ("granite-moe-1b-a400m", "decode_32k")
    assert dryrun._dry_one(*cell, False, None, "baseline",
                           str(tmp_path)) == "ok"
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    read = roofline.analyze_cell(*cell, dryrun_dir=str(tmp_path))
    counted = roofline.analyze_cell(*cell, dryrun_dir=str(tmp_path / "no"))
    assert read["per_chip"] == {
        "flops": rec["cost"]["flops"],
        "hbm_bytes": rec["cost"]["bytes_accessed"],
        "collective_bytes": rec["collective_bytes_total"]}
    assert read["memory"] == rec["memory"]
    assert read["probe"]["microbatches"] == read["microbatches"] == 1
    for key in ("per_chip", "terms_s", "dominant", "memory", "probe"):
        assert counted[key] == read[key], key
    assert read["terms_s"]["compute"] == rec["cost"]["flops"] \
        / roofline.SPEC.peak_flops


def test_summary_renders_the_artifacts(tmp_path):
    ok = {"arch": "a", "shape": "s", "status": "ok",
          "terms_s": {"compute": 1.0, "memory": 2.0, "collective": 0.5},
          "dominant": "memory", "model_flops": 3e12,
          "useful_flops_ratio": 0.5,
          "memory": {"peak_bytes_per_device": 2 ** 31}}
    skip = {"arch": "b", "shape": "s", "status": "skipped",
            "reason": "out of scope"}
    for i, r in enumerate((ok, skip)):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    text = roofline.summary(str(tmp_path))
    assert "| a | s | 1.000e+00 | 2.000e+00 | 5.000e-01 | memory | " \
           "3.00e+12 | 50% | 2.0 |" in text
    assert "skipped: out of scope" in text


def test_report_fills_perf_tables(tmp_path):
    """``launch.report`` replaces the text between each pair of markers
    with a table of one row per arch and one column per shape."""
    from repro_torch.launch import report

    dry, roof = tmp_path / "dryrun", tmp_path / "roofline"
    dry.mkdir()
    roof.mkdir()
    (dry / "a.json").write_text(json.dumps({
        "arch": "granite-moe-1b-a400m", "shape": "decode_32k",
        "multi_pod": False, "status": "ok",
        "memory": {"peak_bytes_per_device": 2 ** 30},
        "cost": {"flops": 2e12}, "collective_bytes_total": 2 ** 29}))
    (dry / "b.json").write_text(json.dumps({
        "arch": "granite-moe-1b-a400m", "shape": "decode_32k",
        "multi_pod": True, "status": "error", "error": "x"}))
    (roof / "a.json").write_text(json.dumps({
        "arch": "granite-moe-1b-a400m", "shape": "decode_32k",
        "status": "ok", "dominant": "memory",
        "terms_s": {"compute": 1e-3, "memory": 2e-3, "collective": 0.0},
        "useful_flops_ratio": 0.25}))
    perf = tmp_path / "PERF.md"
    perf.write_text("# x\n<!-- DRYRUN_TABLE -->\nold\n<!-- /DRYRUN_TABLE -->\n"
                    "mid\n<!-- ROOFLINE_TABLE -->\n<!-- /ROOFLINE_TABLE -->\n"
                    "end\n")
    assert report.main(["--perf", str(perf), "--dryrun-dir", str(dry),
                        "--roofline-dir", str(roof)]) == 0
    text = perf.read_text()
    assert "old" not in text and "mid" in text and text.endswith("end\n")
    row = next(line for line in text.splitlines()
               if line.startswith("| granite-moe-1b-a400m |"))
    assert "| — | — | 1.0 / 2 / 0.5 (mp ERR) | — |" in row
    assert "memo 0.002 s, 25%" in text
    assert text.count("| mixtral-8x7b |") == 2
