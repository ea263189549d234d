"""The port's standing rules.

- No module under ``src/repro_torch/``, nor ``chip_smoke.py``, imports
  ``jax`` or the JAX package (``repro``).
- ``import repro_torch`` works with ``jax`` and ``repro`` unimportable.
- ``device=None`` resolves to the card and raises without one.
- A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises — a failed build is never answered by the plain
  version — and no ``try`` on the kernel path could fall back.
- ``chip_smoke.py`` exits non-zero, printing no result, without a card and
  without the repository around it.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import PlanCache, compress_ffn, flexagon_plan
from repro_torch.config import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import stream as tks


ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


def _run(code, **kwargs):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          **kwargs)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok', sorted(k for k in sys.modules if k.startswith('jax')))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok ['jax']"


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.eye(16, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flexagon_plan(a, a, block_shape=(8, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanCache().get(a, a, block_shape=(8, 8, 8))
    params = {"w_gate": {"w": torch.ones(16, 16)},
              "w_up": {"w": torch.ones(16, 16)},
              "w_down": {"w": torch.ones(16, 16)},
              "block_mask": torch.ones(2, 2)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compress_ffn(params, tokens=4, block=8)
    assert resolve_device("cpu") == torch.device("cpu")


def _schedule_case():
    from repro_torch.core import dataflows as tdf
    from repro_torch.core.formats import dense_to_bcsc, dense_to_bcsr

    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal((24, 16)).astype(np.float32)
    a_r = dense_to_bcsr(a, (8, 8), device="cpu")
    b_c = dense_to_bcsc(b, (8, 8), device="cpu")
    b_r = dense_to_bcsr(b, (8, 8), device="cpu")
    ip = tks.schedule_from_ip(tdf.build_ip_plan(a_r, b_c))
    gust = tks.schedule_from_stream(tdf.build_gust_plan(a_r, b_r),
                                    by_dest=False)
    return a_r, b_c, b_r, ip, gust


def _kernel_case(kernel):
    """(wrapper, CPU args, keyword args) of one call of ``kernel``."""
    if kernel == "gmm":
        x = torch.ones(16, 8)
        w = torch.ones(2, 8, 16)
        gids = torch.tensor([0, 1], dtype=torch.int32)
        return tmg.gmm, (x, w, gids), dict(bm=8, bk=8, bn=8)
    a_r, b_c, b_r, ip, gust = _schedule_case()
    panel = kernel == "stream_panel_spmm"
    sched = tks.device_schedule(gust if panel else ip, "cpu")
    return getattr(tks, kernel), \
        (a_r.data, (b_r if panel else b_c).data, sched), \
        dict(out_grid=(2, 2), out_shape=(16, 16))


@pytest.mark.parametrize("kernel", ["stream_spmm", "stream_panel_spmm",
                                    "gmm"])
def test_failed_build_raises_instead_of_plain(kernel, monkeypatch, tmp_path):
    """A tensor off the CPU takes the kernel path; the build fails; the call
    raises, and no launch is counted.

    K3 is the operator ``repro_torch::gmm``: a CUDA tensor reaches its
    CUDA implementation, which is called here through the dispatcher's
    CUDA key on meta tensors; a meta tensor given to ``gmm`` itself takes
    the operator's fake implementation (the output's shape, no build, no
    launch)."""
    fn, args, kw = _kernel_case(kernel)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    # a "compiler" that rejects nvcc's flags, so the build fails everywhere
    monkeypatch.setattr(build, "nvcc", lambda: sys.executable)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    before = fn.launches
    kernel_path = fn
    if kernel == "gmm":
        cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)

        def kernel_path(x, w, gids, bm, bk, bn):
            return torch.ops.repro_torch.gmm.default.redispatch(
                cuda, x, w, gids, bm, bk, bn, x.dtype)

        fake = fn(*meta, **kw)
        assert fake.device.type == "meta" and fake.shape == (16, 16)
        assert not list(tmp_path.iterdir())             # nothing was built
    with pytest.raises(RuntimeError, match="build failed"):
        kernel_path(*meta, **kw)
    assert fn.launches == before
    # the same call on CPU tensors runs the plain version
    out = fn(*args, **kw)
    assert out.shape == (16, 16) and fn.launches == before


def test_panel_kernel_refuses_a_dest_schedule(monkeypatch):
    """K2 on the card walks a panel schedule's column table; a destination
    -major schedule has none, and the call raises before any build."""
    a_r, b_c, b_r, ip, _ = _schedule_case()
    sched = tks.device_schedule(ip, "cpu")
    assert sched.cols is None
    monkeypatch.setattr(build, "library", lambda name: pytest.fail("built"))
    before = tks.stream_panel_spmm.launches
    with pytest.raises(ValueError, match="column table"):
        tks.stream_panel_spmm(a_r.data.to("meta"), b_r.data.to("meta"),
                              sched, out_grid=(2, 2), out_shape=(16, 16))
    assert tks.stream_panel_spmm.launches == before


def _has_try(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.mark.parametrize("module", ["kernels/stream.py", "kernels/build.py",
                                    "kernels/ip_spmm.py", "kernels/op_spmm.py",
                                    "kernels/gust_spmm.py",
                                    "kernels/moe_gmm.py", "models/moe.py",
                                    "backends/cuda.py"])
def test_kernel_path_has_no_fallback(module):
    assert not _has_try(PORT / module)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_package_surface():
    from repro_torch.api import FlexagonPipeline
    from repro_torch.dist import DistPartition, Partitioner, ShardedPlan
    from repro_torch.memory import PAPER_BUDGET, MemoryBudget, TiledPlan

    assert repro_torch.flexagon_plan is flexagon_plan
    assert {"reference", "cuda", "simulator"} <= set(
        repro_torch.available_backends())
    assert repro_torch.FlexagonPipeline is FlexagonPipeline
    assert repro_torch.MemoryBudget is MemoryBudget
    assert repro_torch.PAPER_BUDGET is PAPER_BUDGET
    assert repro_torch.TiledPlan is TiledPlan
    assert repro_torch.DistPartition is DistPartition
    assert repro_torch.Partitioner is Partitioner
    assert repro_torch.ShardedPlan is ShardedPlan
