"""``repro_torch.launch.specs`` against ``repro.launch.specs``.

The tables (skips, variants, microbatches) equal the reference's, and for
every supported (arch x shape) cell on the 256-rank production mesh each
argument leaf of the port's cell has the global shape and dtype of the
reference cell's leaf (JAX stacks each segment's layers along a leading
axis; the port keeps one dict per layer) and, as rank 0 of a fake process
group, the local shard that the reference's ``NamedSharding`` gives device
0.  The reference's cells are built on a stand-in mesh (what its rules read
of a mesh) with its ``NamedSharding`` recorded, not constructed: no 256
JAX devices and no compile are needed.
"""
import math
import types

import jax
import numpy as np
import pytest

import repro.launch.specs as jspecs
import repro.sharding.rules as jrules
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import specs
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import distribute

MESH_SHAPE, MESH_AXES = (16, 16), ("data", "model")


CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
SUPPORTED = [c for c in CELLS if specs.cell_is_supported(*c) is None]


def test_tables_match_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in JAX_SHAPES.items()}
    assert len(CELLS) == 40 and len(SUPPORTED) == 39
    assert specs.SKIPS == jspecs.SKIPS
    assert [c for c in CELLS if c not in SUPPORTED] == [
        ("seamless-m4t-large-v2", "long_500k")]
    assert specs.TRAIN_MICROBATCHES == jspecs.TRAIN_MICROBATCHES
    assert list(specs.VARIANTS) == list(jspecs.VARIANTS)


@pytest.mark.parametrize("variant", list(jspecs.VARIANTS))
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama3.2-3b"])
def test_variants_match_reference(arch, variant):
    """Each variant is the same config transform and TrainConfig override
    as the reference's: compared field by field on the transformed config."""
    t_fn, t_over = specs.VARIANTS[variant]
    j_fn, j_over = jspecs.VARIANTS[variant]
    assert t_over == j_over
    got, want = t_fn(get_config(arch)), j_fn(jax_get_config(arch))
    for f in ("context_parallel", "n_layers", "d_model"):
        assert getattr(got, f) == getattr(want, f)
    assert (got.moe and got.moe.strategy) == (want.moe and want.moe.strategy)


def _stand_in():
    return types.SimpleNamespace(axis_names=MESH_AXES,
                                 devices=np.empty(MESH_SHAPE, dtype=object))


def _jkey(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_cell(arch, shape, monkeypatch):
    """{path: (shape, dtype, local shape)} of the reference cell's args."""
    monkeypatch.setattr(jrules, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))
    cell = jspecs.build_cell(arch, shape, _stand_in())
    sizes = dict(zip(MESH_AXES, MESH_SHAPE))
    out = {}

    def one(path, leaf, sh):
        if leaf is None:
            return
        parts = list(sh.spec) + [None] * (len(leaf.shape) - len(sh.spec))
        local = []
        for d, part in zip(leaf.shape, parts):
            axes = () if part is None else (
                part if isinstance(part, tuple) else (part,))
            local.append(-(-d // math.prod(sizes[a] for a in axes)))
        out["/".join(_jkey(k) for k in path)] = (
            tuple(leaf.shape), np.dtype(leaf.dtype).name, tuple(local))

    jax.tree_util.tree_map_with_path(
        one, cell.args, cell.in_shardings,
        is_leaf=lambda x: x is None)
    return cell, out


def _port_leaves(tree, prefix=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _port_leaves(v, prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for k, v in zip(tree._fields, tree)
                for pl in _port_leaves(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _port_leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _jax_path(path: str, cfg) -> tuple:
    """The reference's path of a port leaf, and whether JAX stacks it."""
    parts = path.split("/")
    for i, p in enumerate(parts):
        if p == "blocks" or (p == "layers" and cfg.kind != "encdec"):
            layer, n0 = int(parts[i + 1]), 0
            for s, (period, count) in enumerate(cfg.segments()):
                n = len(period) * count
                if layer < n0 + n:
                    j = (layer - n0) % len(period)
                    return "/".join(parts[:i + 1] + [str(s), str(j)]
                                    + parts[i + 2:]), True
                n0 += n
            raise AssertionError(path)
        if p in ("encoder", "decoder"):
            return "/".join(parts[:i + 1] + parts[i + 2:]), True
        if p == "layers":                       # encdec cache: by name
            return "/".join(parts[:i] + parts[i + 2:]), True
    return path, False


@pytest.mark.parametrize("arch,shape", SUPPORTED,
                         ids=[f"{a}-{s}" for a, s in SUPPORTED])
def test_cell_args_match_reference(arch, shape, monkeypatch):
    jcell, want = _jax_cell(arch, shape, monkeypatch)
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        cell = specs.build_cell(arch, shape, mesh)
        assert cell.static_desc == jcell.static_desc
        placed = tuple(distribute(a, s)
                       for a, s in zip(cell.args, cell.in_shardings))
        seen = set()
        cfg = get_config(arch)
        for (path, leaf), (_, d) in zip(_port_leaves(cell.args),
                                        _port_leaves(placed)):
            assert leaf.device.type == "meta", path
            jpath, stacked = _jax_path(path, cfg)
            g, dtype, local = want[jpath]
            if stacked:
                g, local = g[1:], local[1:]
            assert tuple(leaf.shape) == g, (path, leaf.shape, g)
            assert str(leaf.dtype).split(".")[1] == dtype, (path, dtype)
            assert tuple(d.to_local().shape) == local, (path, local)
            seen.add(jpath)
        assert seen == set(want), set(want) ^ seen
