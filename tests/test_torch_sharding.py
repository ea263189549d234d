"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding``, and the sharded forward and train step.

Specs: the port's ``NamedSharding`` keeps the reference's
``PartitionSpec``-shaped tuple beside its DTensor placements, and the
tests compare the tuples entry by entry on the same param paths (JAX
stacks each layer's leaves along a leading axis; the port keeps a list, so
a stacked JAX spec is compared without its layer entry):

- every arch's smoke config on a (data 4, model 2) mesh, the JAX side on
  the conftest's 8 virtual devices, the port's a ``DeviceMesh`` over a
  fake process group (``torch.testing._internal.distributed.fake_pg``);
- every arch's published config on the 256- and 512-rank production
  meshes, on meta tensors; the JAX side calls the rules' spec functions
  with a stand-in mesh (they read only ``axis_names`` and
  ``devices.shape``);
- the caches of ``tests/test_sharding.py::test_cache_shardings_divisible``
  and the batch rule, the uneven batch included.

Every sharded dim divides, as ``tests/test_sharding.py`` checks for JAX.

The sharded path runs in gloo ranks on the CPU: this file, run as a
script, is one rank (it imports only ``repro_torch``).  Four ranks on a
(data 2, model 2) mesh run the smollm-360m and granite-moe-1b-a400m
(MoE ``sort``: K3's plain version inside ``local_map``) smoke forwards
from JAX's params in fp32, held to JAX's unsharded logits within 1e-4 of
the largest logit, and one train step, held to the unsharded port step
within 1e-5 (loss relative; each leaf's gradient against its largest
magnitude).  Two ranks on a (data 1, model 2) mesh run granite at its
published width (2 layers) and must use no collective but ``all_reduce``:
the layout the card runs over gloo, which takes no ``all_gather`` on CUDA
tensors.
"""
import os
import sys

import numpy as np

ARCHS = ("smollm-360m", "granite-moe-1b-a400m")
BATCH, SEQ = 4, 16
#: granite at its published width, cut to 2 layers, on the TP-only mesh
TP_LAYERS, TP_BATCH, TP_SEQ = 2, 2, 16


def _nest(flat):
    """A tree of dicts and lists from ``{"a/0/b": array}`` keys (a digit
    component is a list index)."""
    root = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def _sort_cfg(cfg):
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, strategy="sort"))


def _rank_main(rank: int, world: int, store: str, inputs: str, out: str,
               shape: str) -> int:
    """One gloo rank: the cases of its mesh shape; results to ``out``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import layers

    # fp32 products, as the JAX side computes them
    layers.dense.__defaults__ = (torch.float32,)
    layers.embedding_lookup.__defaults__ = (torch.float32,)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        dims = tuple(int(s) for s in shape.split(","))
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        res = (_tp_case(mesh, CommDebugMode) if dims[0] == 1
               else _dp_tp_cases(mesh, rank, inputs, out, CommDebugMode))
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    return 0


def _flat_grads(grads):
    from repro_torch.checkpoint.checkpointer import tree_flatten

    return [g.full_tensor() if hasattr(g, "full_tensor") else g
            for g in tree_flatten(grads)]


def _dp_tp_cases(mesh, rank, inputs, out, comm_mode):
    import torch

    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     tree_flatten)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import build_model
    from repro_torch.sharding import (abstract_like, batch_sharding,
                                      distribute, params_sharding, use_mesh)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainState, loss_and_grads

    res = {}
    for arch in ARCHS:
        cfg = _sort_cfg(get_config(arch, smoke=True))
        with np.load(os.path.join(inputs, f"{arch}.npz")) as f:
            data = dict(f)
        batch = {k: torch.as_tensor(data.pop(k)) for k in ("tokens",
                                                           "targets")}
        model = build_model(cfg, device="cpu")
        params = lm_params_from_jax(_nest(data), cfg, device="cpu")
        shardings = params_sharding(params, mesh, cfg)
        placed = distribute(params, shardings)
        dbatch = distribute(batch, batch_sharding(batch, mesh))
        comm = comm_mode()
        with use_mesh(mesh), comm, torch.no_grad():
            logits = model.logits(placed, dbatch["tokens"])
        res[f"{arch}/logits"] = logits.full_tensor().numpy()
        res[f"{arch}/collectives"] = comm.get_total_counts()
        if cfg.moe is not None:
            res[f"{arch}/w_gate_local"] = np.asarray(
                placed["blocks"][0]["ffn"]["w_gate"].to_local().shape)

        tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, lr=1e-3,
                           warmup_steps=1, total_steps=4)
        loss0, g0 = loss_and_grads(model, tcfg, params, batch)
        with use_mesh(mesh):
            loss1, g1 = loss_and_grads(model, tcfg, placed, dbatch)
        res[f"{arch}/loss"] = np.array([float(loss0),
                                        float(loss1.full_tensor())])
        res[f"{arch}/grad_err"] = np.array([
            float((b - a).abs().max() / a.abs().max().clamp_min(1e-30))
            for a, b in zip(_flat_grads(g0), _flat_grads(g1))])

        # two whole steps (clip, LR, AdamW on DTensor moments)
        state0 = init_train_state(model, 0, tcfg)
        p1 = distribute(state0.params, params_sharding(state0.params, mesh,
                                                       cfg))
        state1 = TrainState(params=p1, opt=adamw_init(p1), ef=None)
        step0, step1 = make_train_step(model, tcfg), make_train_step(model,
                                                                     tcfg)
        metrics = []
        for _ in range(2):
            state0, m0 = step0(state0, batch)
            with use_mesh(mesh):
                state1, m1 = step1(state1, dbatch)
            metrics.append([float(m0[k]) for k in ("loss", "grad_norm")]
                           + [float(m1[k]) for k in ("loss", "grad_norm")])
        res[f"{arch}/steps"] = np.array(metrics)

        # an unsharded checkpoint restored onto the mesh: each rank's chunk
        ckpt = Checkpointer(os.path.join(os.path.dirname(out),
                                         f"ckpt_{arch}_{rank}"))
        ckpt.save(1, params, blocking=True)
        restored, _ = ckpt.restore(abstract_like(params),
                                   shardings=shardings, device="cpu")
        res[f"{arch}/restore_exact"] = all(
            torch.equal(a.to_local(), b.to_local())
            and a.placements == b.placements
            for a, b in zip(tree_flatten(restored), tree_flatten(placed)))

    # launch.train.train on the mesh: 2 steps with checkpoints (rank 0
    # writes), then a run resumed from step 2, against 3 unsharded steps
    from repro_torch.launch.train import train

    cfg = _sort_cfg(get_config("granite-moe-1b-a400m", smoke=True))
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, lr=1e-3,
                       warmup_steps=1, total_steps=3)
    shared = os.path.join(os.path.dirname(out), "train_ckpt")
    _, plain = train(cfg, tcfg, steps=3, device="cpu", log_every=100)
    _, sharded = train(cfg, tcfg, steps=2, mesh=mesh, ckpt_dir=shared,
                       ckpt_every=1, log_every=100)
    _, resumed = train(cfg, tcfg, steps=3, mesh=mesh, ckpt_dir=shared,
                       resume=True, log_every=100)
    res["train/plain"] = np.array([h["loss"] for h in plain])
    res["train/mesh"] = np.array([h["loss"] for h in sharded + resumed])
    res["train/steps"] = np.array([h["step"] for h in sharded + resumed])
    return res


def _tp_case(mesh, comm_mode):
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import (batch_sharding, distribute,
                                      params_sharding, use_mesh)

    cfg = dataclasses.replace(_sort_cfg(get_config("granite-moe-1b-a400m")),
                              n_layers=TP_LAYERS)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (TP_BATCH, TP_SEQ)))
    with torch.no_grad():
        want = model.logits(params, tokens)
    placed = distribute(params, params_sharding(params, mesh, cfg))
    batch = distribute({"tokens": tokens},
                       batch_sharding({"tokens": tokens}, mesh))
    comm = comm_mode()
    with use_mesh(mesh), comm, torch.no_grad():
        got = model.logits(placed, batch["tokens"]).full_tensor()
    ffn = placed["blocks"][0]["ffn"]
    return {
        "err": float((got - want).abs().max() / want.abs().max()),
        "kinds": np.array(sorted(str(k) for k in comm.get_comm_counts())),
        "collectives": comm.get_total_counts(),
        "w_gate_local": np.asarray(ffn["w_gate"].to_local().shape),
        "w_down_local": np.asarray(ffn["w_down"].to_local().shape),
        "router_local": np.asarray(ffn["router"]["w"].to_local().shape),
    }


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4], sys.argv[5], sys.argv[6]))


import contextlib  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.sharding import batch_sharding as jax_batch_sharding  # noqa: E402
from repro.sharding import cache_sharding as jax_cache_sharding  # noqa: E402
from repro.sharding import params_sharding as jax_params_sharding  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import (encdec_params_from_jax,  # noqa: E402
                                 lm_params_from_jax)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import (DATA_AXES, NamedSharding,  # noqa: E402
                                  abstract_like, batch_sharding,
                                  cache_sharding, distribute, params_sharding,
                                  shard, use_mesh)
from repro_torch.sharding.act import split_heads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: each gloo rank's limit: a hung rendezvous fails its test, not the suite
RANK_TIMEOUT_S = 300


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks in this process (no
    communication; collectives return at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _stand_in(shape, names):
    """What ``repro.sharding.rules`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _jax_path(elems) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in elems)


def _jax_specs(tree, spec_of):
    """{JAX path: spec tuple} over a tree of leaves with ``.shape``."""
    out = {}

    def one(elems, leaf):
        out[_jax_path(elems)] = tuple(spec_of(_jax_path(elems), leaf))
        return leaf

    jax.tree_util.tree_map_with_path(one, tree)
    return out


def _jax_named_specs(shardings):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda e, s: out.__setitem__(_jax_path(e), tuple(s.spec)),
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
    return out


def _port_paths(tree, prefix=()):
    """[(path, leaf)] of a port tree (list entries by index)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _port_paths(v, prefix + (str(k),))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in _port_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_jax_path(path: str, cfg, kind: str) -> tuple:
    """The JAX path of a port leaf, and whether JAX stacks it (the mapping
    of ``repro_torch.convert.lm_params_from_jax``)."""
    parts = path.split("/")
    if parts[0] == "blocks" or (kind == "cache" and parts[0] == "layers"
                                and cfg.kind != "encdec"):
        layer, i = int(parts[1]), 0
        for s, (period, count) in enumerate(cfg.segments()):
            n = len(period) * count
            if layer < i + n:
                j = (layer - i) % len(period)
                return "/".join([parts[0], str(s), str(j)] + parts[2:]), True
            i += n
        raise AssertionError(path)
    if parts[0] in ("encoder", "decoder"):
        return "/".join([parts[0]] + parts[2:]), True
    if kind == "cache" and parts[0] == "layers":      # encdec: per name
        return "/".join(parts[2:]), True
    return path, False


def _check_against(port_tree, port_shardings, jax_specs, cfg, kind, mesh):
    """Every port leaf's spec equals the JAX spec of its path (without the
    layer entry where JAX stacks); its placements stand for that spec; and
    every sharded dim divides."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    names = list(mesh.mesh_dim_names)
    seen = set()
    for (path, leaf), (_, sh) in zip(_port_paths(port_tree),
                                     _port_paths(port_shardings)):
        jpath, stacked = _to_jax_path(path, cfg, kind)
        want = jax_specs[jpath]
        if stacked:
            assert want[0] is None, (jpath, want)
            want = want[1:]
        assert sh.spec == want, (path, sh.spec, want)
        seen.add(jpath)
        for dim, part in enumerate(sh.spec):
            if part is None:
                continue
            axes = part if isinstance(part, tuple) else (part,)
            prod = int(np.prod([sizes[a] for a in axes]))
            assert leaf.shape[dim] % prod == 0, (path, leaf.shape, sh.spec)
            for a in axes:
                assert sh.placements[names.index(a)].dim == dim, path
        assert sum(p.is_shard() for p in sh.placements) == sum(
            len(p) if isinstance(p, tuple) else 1
            for p in sh.spec if p is not None), path
    assert seen == set(jax_specs), set(jax_specs) - seen


def _port_skeleton(cfg, struct):
    conv = encdec_params_from_jax if cfg.kind == "encdec" \
        else lm_params_from_jax
    return conv(struct, cfg, device="meta")


_STRUCTS = {}


def _jax_struct(arch, smoke):
    key = (arch, smoke)
    if key not in _STRUCTS:
        cfg = jax_get_config(arch, smoke=smoke)
        _STRUCTS[key] = jax.eval_shape(jax_build_model(cfg).init,
                                       jax.random.PRNGKey(0))
    return _STRUCTS[key]


# ---------------------------------------------------------------------------
# rules against the reference's specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference_smoke(arch):
    jmesh = jax.make_mesh((4, 2), ("data", "model"))
    struct = _jax_struct(arch, True)
    jcfg = jax_get_config(arch, smoke=True)
    want = _jax_named_specs(jax_params_sharding(struct, jmesh, jcfg))
    cfg = get_config(arch, smoke=True)
    with fake_world(8):
        mesh = _device_mesh((4, 2), ("data", "model"))
        skel = _port_skeleton(cfg, struct)
        sh = params_sharding(skel, mesh, cfg)
        _check_against(skel, sh, want, cfg, "params", mesh)
        # the rules hold on the real leaves too, not only on meta skeletons
        real = build_model(cfg, device="cpu").init(0)
        assert params_sharding(real, mesh, cfg) == sh


def _published_case(arch, multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jcfg = jax_get_config(arch)
    stand_in = _stand_in(shape, names)

    def spec_of(path, leaf):
        # repro.sharding.rules.params_sharding's rule for one leaf
        if jrules._is_stacked(path) and len(leaf.shape) >= 1:
            spec = P(None, *jrules._param_spec(path, leaf.shape[1:],
                                               stand_in, jcfg))
        else:
            spec = jrules._param_spec(path, leaf.shape, stand_in, jcfg)
        return jrules._sanitize(spec, leaf.shape, stand_in)

    struct = _jax_struct(arch, False)
    return struct, _jax_specs(struct, spec_of), shape, names


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference_published(arch, multi_pod):
    struct, want, shape, names = _published_case(arch, multi_pod)
    cfg = get_config(arch)
    # a rank past the first pod and data row: its chunks are not the first
    with fake_world(int(np.prod(shape)), rank=int(np.prod(shape)) - 3):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert tuple(mesh.mesh_dim_names) == names
        skel = _port_skeleton(cfg, struct)
        sh = params_sharding(skel, mesh, cfg)
        _check_against(skel, sh, want, cfg, "params", mesh)
        # meta DTensors carry the global shape and this rank's chunk
        for leaf, d in zip(tree_flatten(skel),
                           tree_flatten(distribute(skel, sh))):
            assert tuple(d.shape) == tuple(leaf.shape)
            local = list(leaf.shape)
            for i, p in enumerate(d.placements):
                if p.is_shard():
                    local[p.dim] //= shape[i]
            assert tuple(d.to_local().shape) == tuple(local)


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-v0.1-52b",
                                  "rwkv6-3b", "mixtral-8x7b",
                                  "seamless-m4t-large-v2"])
def test_cache_specs_match_reference(arch):
    jmesh = jax.make_mesh((4, 2), ("data", "model"))
    jcfg = jax_get_config(arch, smoke=True)
    jmodel = jax_build_model(jcfg)
    struct = jax.eval_shape(lambda: jmodel.init_cache(4, 32))
    want = _jax_named_specs(jax_cache_sharding(struct, jmesh, jcfg))
    cfg = get_config(arch, smoke=True)
    cache = build_model(cfg, device="cpu").init_cache(4, 32)
    with fake_world(8):
        mesh = _device_mesh((4, 2), ("data", "model"))
        _check_against(cache, cache_sharding(cache, mesh, cfg), want, cfg,
                       "cache", mesh)


@pytest.mark.parametrize("batch", [1, 3, 4, 8, 32, 64])
@pytest.mark.parametrize("shape", [(4, 2), (16, 16), (2, 16, 16)],
                         ids=["4x2", "16x16", "2x16x16"])
def test_batch_specs_match_reference(shape, batch):
    names = ("data", "model") if len(shape) == 2 \
        else ("pod", "data", "model")
    leaves = {"tokens": (batch, 8), "mask": (batch, 8, 2), "step": ()}
    want = {}
    stand_in = _stand_in(shape, names)
    sizes = dict(zip(names, shape))
    axes = tuple(a for a in ("pod", "data") if a in names)
    dp = int(np.prod([sizes[a] for a in axes]))
    for k, s in leaves.items():
        # repro.sharding.rules.batch_sharding's rule, on the stand-in mesh
        if not s:
            want[k] = ()
            continue
        if s[0] % dp == 0 and dp > 1:
            spec = P(axes, *([None] * (len(s) - 1)))
        elif s[0] % sizes["data"] == 0 and sizes["data"] > 1:
            spec = P("data", *([None] * (len(s) - 1)))
        else:
            spec = P(*([None] * len(s)))
        want[k] = tuple(jrules._sanitize(spec, s, stand_in))
    if shape == (4, 2):
        jmesh = jax.make_mesh(shape, names)
        got = jax_batch_sharding(
            {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in leaves.items()},
            jmesh)
        assert {k: tuple(v.spec) for k, v in got.items()} == want
    with fake_world(int(np.prod(shape))):
        mesh = _device_mesh(shape, names)
        port = batch_sharding({k: torch.empty(s, device="meta")
                               for k, s in leaves.items()}, mesh)
    assert {k: v.spec for k, v in port.items()} == want


def test_batch_sharding_uneven_batch():
    jmesh = jax.make_mesh((4, 2), ("data", "model"))
    jsh = jax_batch_sharding(
        {"tokens": jax.ShapeDtypeStruct((3, 8), jnp.int32)}, jmesh)
    with fake_world(8):
        mesh = _device_mesh((4, 2), ("data", "model"))
        sh = batch_sharding({"tokens": torch.empty((3, 8), device="meta")},
                            mesh)
    # a batch of 3 cannot shard over the data axis: it replicates
    assert sh["tokens"].spec == (None, None) == tuple(jsh["tokens"].spec)
    assert all(p.is_replicate() for p in sh["tokens"].placements)


# ---------------------------------------------------------------------------
# placements, meshes and activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank,offset", [(0, 0), (37, 2), (300, 18)])
def test_two_axes_on_one_dim_in_mesh_order(rank, offset):
    """("pod", "data") on one dim: DTensor's chunk order is JAX's (pod
    outermost).  Rank r sits at (pod r // 256, data r % 256 // 16)."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(512, rank=rank):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        s = NamedSharding(mesh, (DATA_AXES, None))
        assert s.placements == (Shard(0), Shard(0), Replicate())
        leaf = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
        local = distribute({"x": leaf}, {"x": s})["x"].to_local()
    assert torch.equal(local, leaf[2 * offset: 2 * offset + 2])


def test_spec_out_of_mesh_order_raises():
    with fake_world(8):
        mesh = _device_mesh((2, 2, 2), ("pod", "data", "model"))
        with pytest.raises(ValueError, match="mesh order"):
            NamedSharding(mesh, (("data", "pod"), None)).placements


@pytest.mark.parametrize("world", [8, 255])
def test_make_production_mesh_needs_its_world(world):
    with fake_world(world):
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device_type="cpu")


def test_make_production_mesh_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device_type="cpu")


def test_shard_is_noop_without_mesh():
    x = torch.randn(4, 6)
    assert shard(x, "dp", "model") is x
    with fake_world(8):
        mesh = _device_mesh((4, 2), ("data", "model"))
        with use_mesh(mesh):
            # a plain tensor is left as it is under a mesh too
            assert shard(x, "dp", "model") is x
        d = distribute({"x": x}, {"x": NamedSharding(mesh, ("data", None))})
        # a DTensor outside use_mesh: no mesh named, nothing to do
        assert shard(d["x"], None, "model") is d["x"]
    y = torch.randn(2, 3, 8)
    assert torch.equal(split_heads(y, 4), y.reshape(2, 3, 4, 2))


def test_shard_drops_axes_that_do_not_divide():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = _device_mesh((4, 2), ("data", "model"))
        x = distribute({"x": torch.empty((8, 3, 6), device="meta")},
                       {"x": NamedSharding(mesh, (None, None, None))})["x"]
        with use_mesh(mesh):
            # 3 does not divide over model: that entry is dropped
            y = shard(x, "dp", "model", None)
            z = shard(x, "dp", None, "model")
            assert shard(z, "dp", None, "model") is z
    assert y.placements == (Shard(0), Replicate())
    assert z.placements == (Shard(0), Shard(2))
    assert z.to_local().shape == (2, 3, 3)


def test_abstract_like_is_meta():
    tree = {"a": torch.ones(2, 3), "b": [torch.zeros(4, dtype=torch.int32)]}
    out = abstract_like(tree)
    assert out["a"].device.type == "meta" and out["a"].shape == (2, 3)
    assert out["b"][0].dtype == torch.int32


# ---------------------------------------------------------------------------
# the sharded path in gloo ranks
# ---------------------------------------------------------------------------


def _spawn(world, shape, tmp, inputs):
    """Run ``world`` ranks of this file on a ``shape`` mesh; every rank
    must exit 0 within RANK_TIMEOUT_S.  Returns each rank's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(store),
         str(inputs), str(tmp / f"rank{r}.npz"), shape], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
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


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's smoke params (key 0) and fp32 logits of each arch, and the
    params and batch written for the ranks."""
    inputs = tmp_path_factory.mktemp("inputs")
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        for fn in (jlayers.dense, jlayers.embedding_lookup):
            mp.setattr(fn, "__defaults__", (jnp.float32,))
        for arch in ARCHS:
            cfg = _sort_cfg(jax_get_config(arch, smoke=True))
            model = jax_build_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            rng = np.random.default_rng(1)
            tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int64)
            targets = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(
                np.int64)
            want[arch] = np.asarray(
                model.logits(params, jnp.asarray(tokens), remat=False),
                np.float32)
            flat = {}
            jax.tree_util.tree_map_with_path(
                lambda e, x: flat.__setitem__(_jax_path(e), np.asarray(x)),
                params)
            np.savez(inputs / f"{arch}.npz", tokens=tokens, targets=targets,
                     **flat)
    return inputs, want


@pytest.fixture(scope="module")
def dp_tp_ranks(jax_side, tmp_path_factory):
    inputs, _ = jax_side
    return _spawn(4, "2,2", tmp_path_factory.mktemp("gloo4"), inputs)


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo2")
    return _spawn(2, "1,2", tmp, tmp)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_jax(arch, jax_side, dp_tp_ranks):
    _, want = jax_side
    scale = np.abs(want[arch]).max()
    for r, res in enumerate(dp_tp_ranks):
        got = res[f"{arch}/logits"]
        assert got.shape == want[arch].shape
        err = np.abs(got - want[arch]).max() / scale
        assert err <= 1e-4, (r, err)
        assert int(res[f"{arch}/collectives"]) > 0, r


def test_moe_experts_split_over_model(dp_tp_ranks):
    """granite's smoke experts (E 4, D 64, F 32): EP over data (4 / 2)
    and d_ff over model (32 / 2) on each rank."""
    for res in dp_tp_ranks:
        assert tuple(res["granite-moe-1b-a400m/w_gate_local"]) == (2, 64, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(arch, dp_tp_ranks):
    for r, res in enumerate(dp_tp_ranks):
        l0, l1 = res[f"{arch}/loss"]
        assert abs(l1 - l0) <= 1e-5 * abs(l0), (r, l0, l1)
        assert res[f"{arch}/grad_err"].max() <= 1e-5, r
        for step in res[f"{arch}/steps"]:
            for a, b in zip(step[:2], step[2:]):
                assert abs(b - a) <= 1e-5 * abs(a), (r, step)


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_onto_mesh_is_exact(arch, dp_tp_ranks):
    for r, res in enumerate(dp_tp_ranks):
        assert bool(res[f"{arch}/restore_exact"]), r


def test_launch_train_on_mesh_matches_unsharded(dp_tp_ranks):
    """``launch.train.train(..., mesh=...)``: 2 steps, then a run resumed
    from the step-2 checkpoint rank 0 wrote, step for step with 3
    unsharded steps (a resume keeps the params, whose loss it reports
    before its first update)."""
    for r, res in enumerate(dp_tp_ranks):
        assert res["train/steps"].tolist() == [0, 1, 2], r
        np.testing.assert_allclose(res["train/mesh"], res["train/plain"],
                                   rtol=1e-5)


def test_tp_mesh_forward_uses_only_all_reduce(tp_ranks):
    """granite at its published width on (data 1, model 2): each rank's
    attention heads, expert d_ff slices and router columns are its halves,
    and every collective is an all_reduce."""
    for r, res in enumerate(tp_ranks):
        assert res["err"] <= 1e-4, (r, res["err"])
        assert int(res["collectives"]) > 0, r
        kinds = set(res["kinds"].tolist())
        assert kinds <= {"c10d_functional.all_reduce", "c10d.allreduce_"}, \
            kinds
        assert tuple(res["w_gate_local"]) == (32, 1024, 256)
        assert tuple(res["w_down_local"]) == (32, 256, 1024)
        assert tuple(res["router_local"]) == (1024, 16)
