"""Checkpointing of tensor trees: async save, retention, restore.

The port of ``repro.checkpoint.checkpointer``, with its on-disk layout:
``step_XXXXXXXX/arrays.npz`` holds every leaf as ``leaf_i`` and
``manifest.msgpack`` the step and the leaf count.  A tree is nested dicts,
lists and tuples of tensors (or numpy arrays); its leaves are numbered in
``jax.tree.flatten``'s order (dict keys sorted, sequences in order, ``None``
no leaf), so ``leaf_i`` names the same leaf in both packages for trees of
the same structure, and either package restores what the other saved.

Two things differ from the reference, neither on disk:

- the manifest is written by :func:`pack_manifest`, a msgpack encoder of
  the one map the file holds, byte-equal to ``msgpack.packb``;
- bf16 leaves, which numpy has no type for without ``ml_dtypes``, are
  stored as their 16-bit patterns in numpy's 2-byte void type (``V2``),
  the same bytes and type JAX's bf16 leaves get on disk.  Restore reads a
  ``V2`` leaf as bf16 bits, so a bf16 leaf comes back bit for bit (the
  reference cannot cast ``V2`` back and fails on it) and converts from
  there to the like-tree's dtype.

Async: ``save`` copies the leaves to host memory at once and writes them to
disk on a background thread, under ``step_XXXXXXXX.tmp``, renamed when
complete.  ``restore(..., shardings=...)`` places each leaf on a mesh by
its placements (:mod:`repro_torch.sharding`), each rank keeping its own
chunk of the stored array.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["Checkpointer", "pack_manifest", "tree_flatten", "tree_map",
           "tree_unflatten"]


# -- trees -------------------------------------------------------------------


def tree_flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_flatten(x)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced by ``leaves`` (in
    :func:`tree_flatten`'s order)."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}
        if isinstance(x, (list, tuple)):
            items = [build(v) for v in x]
            if isinstance(x, list):
                return items
            return type(x)(*items) if hasattr(x, "_fields") \
                else type(x)(items)
        if x is None:
            return None
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    flat = [tree_flatten(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


# -- manifest ----------------------------------------------------------------


def _pack_uint(n: int) -> bytes:
    """msgpack's shortest form of a non-negative int."""
    if n < 0 or n >= 2 ** 64:
        raise ValueError(f"manifest: {n} is not a uint64")
    if n < 0x80:
        return bytes([n])                       # positive fixint
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_key(key: str) -> bytes:
    raw = key.encode()
    if len(raw) > 31:
        raise ValueError(f"manifest: key {key!r} is over a fixstr")
    return bytes([0xA0 | len(raw)]) + raw       # fixstr


def pack_manifest(step: int, n_leaves: int) -> bytes:
    """``msgpack.packb({"step": step, "n_leaves": n_leaves})``, byte for
    byte: a fixmap of two fixstr keys, each int in its shortest form."""
    return (bytes([0x80 | 2]) + _pack_key("step") + _pack_uint(step)
            + _pack_key("n_leaves") + _pack_uint(n_leaves))


# -- leaves ------------------------------------------------------------------


#: numpy's type for a bf16 leaf on disk: its 16-bit patterns, as JAX's
BF16_ON_DISK = np.dtype("V2")


def _to_numpy(x) -> np.ndarray:
    """A leaf as the array written to disk: bf16 as its bit patterns."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_ON_DISK).copy()
        return t.numpy().copy()
    return np.array(x)


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The stored array as a tensor of ``dtype``: a ``V2`` leaf read as bf16
    bits, then converted (no change for a bf16 like-leaf); anything else
    converted as ``astype`` would."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == BF16_ON_DISK:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dtype)


def _dtype(like) -> torch.dtype:
    if isinstance(like, torch.Tensor):
        return like.dtype
    return torch.from_numpy(np.zeros(0, np.dtype(like.dtype))).dtype


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> str:
        """Snapshot now, write in the background (unless blocking)."""
        self.wait()
        arrs: Dict[str, np.ndarray] = {
            f"leaf_{i}": _to_numpy(x)
            for i, x in enumerate(tree_flatten(tree))}
        path = os.path.join(self.directory, f"step_{step:08d}")
        tmp = path + ".tmp"

        def write():
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
            with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
                f.write(pack_manifest(step, len(arrs)))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
            self._gc()

        def write_in_background():
            try:
                write()
            except Exception as e:     # raised again by wait()
                self._error = e

        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write_in_background,
                                             daemon=True)
            self._pending.start()
        return path

    def wait(self):
        """Join the background write; raise what it raised, if anything."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, *, step: Optional[int] = None, shardings=None,
                device=None):
        """Rebuild ``like``'s tree from the checkpoint at ``step`` (default:
        the latest); returns ``(tree, step)``.

        ``like``'s leaves give each leaf's shape and dtype: tensors (a
        ``device="meta"`` tensor is enough) or numpy arrays.  A shape that
        differs from the stored one raises ``ValueError``.  The leaves come
        back as tensors on ``device`` (``None``: the card), or, with
        ``shardings`` (a :class:`repro_torch.sharding.NamedSharding` tree
        beside ``like``, as ``params_sharding`` gives it), as DTensors on
        their meshes: each rank reads the stored array and keeps its own
        chunk, with no collective, on its own device of the mesh.
        """
        self.wait()
        if shardings is not None:
            from ..sharding.rules import distribute

            if device is None:
                from ..launch.mesh import process_mesh_device

                mesh = tree_flatten(shardings)[0].mesh
                device = process_mesh_device(mesh)
            whole, step = self.restore(like, step=step, device=device)
            return distribute(whole, shardings), step
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        restored = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, leaf in enumerate(tree_flatten(like)):
                arr = data[f"leaf_{i}"]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"leaf {i}: checkpoint shape {arr.shape} != "
                        f"model shape {tuple(leaf.shape)}")
                restored.append(_from_numpy(arr, _dtype(leaf)).to(dev))
        return tree_unflatten(like, restored), step
