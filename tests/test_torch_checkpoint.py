"""The port's ``Checkpointer`` against the JAX package's.

``tests/test_checkpoint.py``'s cases on the port (its elastic re-shard,
which needs a mesh, replaced by restoring onto ``device="cpu"`` a tree
saved as bf16 and as fp32), the manifest byte-equal to ``msgpack.packb``,
restores across the two packages both ways on one dict tree, and bf16
leaves bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer

from repro_torch.checkpoint.checkpointer import (Checkpointer, pack_manifest,
                                                 tree_flatten)


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = tree()
    ck.save(7, t, blocking=True)
    like = {"a": _meta(t["a"]), "b": {"c": _meta(t["b"]["c"])}}
    restored, step = ck.restore(like, device="cpu")
    assert step == 7
    for a, b in zip(tree_flatten(t), tree_flatten(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        ck.save(s, tree())
    ck.wait()
    assert ck.all_steps() == [30, 40]
    assert ck.latest_step() == 40
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree(), blocking=True)
    bad = {"a": torch.empty((4, 4), device="meta"),
           "b": {"c": torch.empty((5,), dtype=torch.int32, device="meta")}}
    with pytest.raises(ValueError):
        ck.restore(bad, device="cpu")


@pytest.mark.parametrize("saved", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want", [torch.float32, torch.bfloat16])
def test_restore_onto_cpu(tmp_path, saved, want):
    """A tree saved as bf16 or fp32 restores onto ``device="cpu"`` in the
    like-tree's dtype: bits kept where the dtypes agree, ``.to()``'s
    rounding where they differ."""
    x = torch.linspace(-3, 3, 24).reshape(4, 6).to(saved)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": x}, blocking=True)
    restored, _ = ck.restore({"x": torch.empty((4, 6), dtype=want,
                                               device="meta")}, device="cpu")
    got = restored["x"]
    assert got.device.type == "cpu" and got.dtype == want
    assert torch.equal(got, x.to(want))


def test_bf16_round_trip_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 16, size=(7, 9), dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": [x, x[:2]]}, blocking=True)
    restored, _ = ck.restore({"w": [_meta(x), _meta(x[:2])]}, device="cpu")
    for a, b in zip([x, x[:2]], restored["w"]):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("s", [0, 127, 128, 255, 256, 65535, 65536,
                               2 ** 32 - 1])
def test_manifest_byte_equal_to_msgpack(tmp_path, s):
    assert pack_manifest(s, 3) == msgpack.packb({"step": s, "n_leaves": 3})
    ck = Checkpointer(str(tmp_path))
    ck.save(s, tree(), blocking=True)
    path = os.path.join(tmp_path, f"step_{s:08d}", "manifest.msgpack")
    with open(path, "rb") as f:
        raw = f.read()
    assert raw == msgpack.packb({"step": s, "n_leaves": 2})
    assert msgpack.unpackb(raw) == {"step": s, "n_leaves": 2}


def _dict_tree(rng):
    return {"z": rng.standard_normal((3, 4)).astype(np.float32),
            "a": {"k": rng.integers(0, 9, (5,)).astype(np.int32),
                  "b": rng.standard_normal((2, 2, 3)).astype(np.float32)},
            "m": rng.standard_normal((6,)).astype(np.float32)}


def test_leaf_order_is_jax_order():
    t = _dict_tree(np.random.default_rng(1))
    for a, b in zip(tree_flatten(t), jax.tree.leaves(t)):
        assert a is b


def test_jax_saves_port_restores(tmp_path):
    t = _dict_tree(np.random.default_rng(2))
    JaxCheckpointer(str(tmp_path)).save(5, jax.tree.map(jnp.asarray, t),
                                        blocking=True)
    like = {"z": torch.empty((3, 4), device="meta"),
            "a": {"k": torch.empty((5,), dtype=torch.int32, device="meta"),
                  "b": torch.empty((2, 2, 3), device="meta")},
            "m": torch.empty((6,), device="meta")}
    restored, step = Checkpointer(str(tmp_path)).restore(like, device="cpu")
    assert step == 5
    for a, b in zip(tree_flatten(t), tree_flatten(restored)):
        assert b.numpy().dtype == a.dtype and np.array_equal(b.numpy(), a)


def test_jax_bf16_restores_bit_for_bit(tmp_path):
    """A bf16 leaf that JAX wrote (numpy's ``V2``) restores by its bits."""
    x = jnp.asarray(np.linspace(-2, 2, 10, dtype=np.float32)).astype(
        jnp.bfloat16)
    JaxCheckpointer(str(tmp_path)).save(1, {"x": x}, blocking=True)
    restored, _ = Checkpointer(str(tmp_path)).restore(
        {"x": torch.empty((10,), dtype=torch.bfloat16, device="meta")},
        device="cpu")
    want = np.asarray(x).view(np.uint16)
    assert restored["x"].view(torch.int16).numpy().view(np.uint16).tobytes() \
        == want.tobytes()


def test_port_saves_jax_restores(tmp_path):
    t = _dict_tree(np.random.default_rng(3))
    Checkpointer(str(tmp_path)).save(
        9, {"z": torch.as_tensor(t["z"]),
            "a": {"k": torch.as_tensor(t["a"]["k"]),
                  "b": torch.as_tensor(t["a"]["b"])},
            "m": torch.as_tensor(t["m"])}, blocking=True)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)
    restored, step = JaxCheckpointer(str(tmp_path)).restore(like)
    assert step == 9
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(restored)):
        assert np.asarray(b).dtype == a.dtype
        assert np.array_equal(np.asarray(b), a)
