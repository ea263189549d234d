"""Multi-pod dry-run: run every (architecture x input shape) cell on meta
tensors over the production mesh, as rank 0 of a fake process group, and
record its memory, cost and collectives.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell for 256 (or 512) virtual TPU devices and reads XLA's
analyses, the port runs the cell's step once in eager mode, its arguments
meta DTensors (shapes, no storage) on a ``DeviceMesh`` over a fake process
group of 256 (or 512) ranks.  Nothing touches a card.

What it records, for rank 0:

- ``memory``: ``argument_bytes`` (the local shards of every argument the
  step reads: ``jax.jit`` drops the others, as the prefill's old cache
  position), ``alias_bytes`` (those of the donated arguments),
  ``output_bytes`` (the local shards of the outputs), ``temp_bytes`` (the
  peak of the bytes held by storages the step made, outputs included,
  measured by :class:`CostMode`'s live-bytes count) and
  ``peak_bytes_per_device = argument_bytes + temp_bytes`` as in the
  reference;
- ``cost``: ``flops`` (``torch.utils.flop_counter``'s formulas, K3/K3w's
  included), ``transcendentals`` (output elements of :data:`TRANSCENDENTAL`
  ops) and ``bytes_accessed`` (input plus output bytes of every op: the
  unfused upper bound, as the reference's is);
- ``collectives``: count and result-shape bytes per kind, under the
  reference's names, read from the collective ops DTensor issues.

:class:`CostMode` counts only the rank's local ops: it steps aside for
every op with a DTensor argument, so it sees what DTensor runs on the
local shards.  DTensor's sharding propagation runs each new (op, placement)
once at the global shapes, on fake tensors, and caches the answer; the mode
counts no op on a fake tensor, so one run counts what a second run with
the cache warm would (``count_cell(..., warm=True)``; the tests hold the
two equal).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multipod] [--out artifacts/torch/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] \
        [--jobs 4]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import sys
import traceback
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from .. import obs
from ..configs import ARCH_IDS
from ..configs.base import SHAPES
from ..sharding import distribute, use_mesh
from .mesh import make_production_mesh
from .specs import build_cell, cell_is_supported

__all__ = ["COLLECTIVES", "TRANSCENDENTAL", "CostMode", "fake_world",
           "local_bytes", "map_cells", "run_cell", "count_cell"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: collective ops (``_c10d_functional``, which DTensor issues, and
#: ``c10d``, the process group's own) by the reference's kind names
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

#: ops whose output elements count as transcendentals (XLA's sense: one
#: per exp, log, tanh, rsqrt, ... of an element)
TRANSCENDENTAL = frozenset((
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "tanh",
    "sigmoid", "silu", "silu_", "gelu", "rsqrt", "sqrt", "sin", "cos", "erf",
    "softplus", "_softmax", "_log_softmax", "logsumexp"))


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


def _tensors(tree):
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the local work of the rank it runs on.

    Every op with a DTensor argument returns ``NotImplemented``, so DTensor
    handles it and the mode sees the ops DTensor runs on local shards (and
    the collectives it issues).  For each local op it adds the op's FLOPs
    (``flop_registry``), its transcendentals, its input and output bytes
    (views move none), and for a collective its count and result bytes.
    It also keeps the bytes live in storages the ops made (freed when the
    storage is) and their peak; :meth:`hold` leaves existing storages out.
    Only ops on meta tensors count: the step's tensors are meta, and
    DTensor computes shard sizes on small host tensors, once per process
    (an ``lru_cache``), which is not the step's work.

    On meta tensors a pure op's outputs, FLOPs and bytes depend on its
    inputs' shapes, strides and dtypes alone, so the mode runs each
    distinct call once and replays it after (fresh meta outputs of the
    recorded layout): a model's layers and blocks repeat the same calls.
    A call whose output shares an input's storage is not replayed.  On
    granite-moe-1b-a400m's ``train_4k`` the replay cuts the dry-run from
    231 s to 90 s on a CPU, the counts equal.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.collectives = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        #: storages of the held arguments -> whether an op read them
        self._args = WeakIdKeyDictionary()
        self._memo = {}

    def hold(self, tree):
        """Leave the storages of ``tree``'s tensors (a DTensor's local
        shard) out of the live bytes: they exist before the step (its
        arguments), and an in-place op on them makes nothing new."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            self._seen[t.untyped_storage()] = 0
            self._args[t.untyped_storage()] = False

    def read_bytes(self, tree) -> int:
        """Bytes this rank holds of the leaves of ``tree`` (held by
        :meth:`hold`) that an op read: ``jax.jit`` drops the arguments a
        step never reads, and XLA counts none of their bytes."""
        from torch.distributed.tensor import DTensor

        total = 0
        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            if self._args.get(t.untyped_storage()):
                total += _nbytes(t)
        return total

    def _free(self, n: int):
        self.live_bytes -= n

    def _track(self, out):
        for t in _tensors(out):
            s = t.untyped_storage()
            if s in self._seen:
                continue
            n = s.nbytes()
            self._seen[s] = n
            self.live_bytes += n
            weakref.finalize(s, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if len(self._args):
            for t in _tensors((args, kwargs)):
                s = t.untyped_storage()
                if s in self._args:
                    self._args[s] = True
        key = self._memo_key(func, types, args, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            metas, flops, trans, nbytes = hit
            out = [torch.empty_strided(shape, stride, dtype=dtype,
                                       device="meta")
                   for shape, stride, dtype in metas]
            out = tuple(out) if isinstance(metas, tuple) else out[0]
            self._add(func, flops, trans, nbytes)
            self._track(out)
            return out
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            return out      # DTensor's sharding propagation at global shapes
        if not any(t.device.type == "meta"
                   for t in _tensors((args, kwargs, out))):
            return out      # DTensor's shard sizes, on host tensors
        name = func._opname
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                entry = self.collectives.setdefault(
                    kind, {"count": 0, "bytes": 0})
                entry["count"] += 1
                entry["bytes"] += sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
            return out
        packet = func._overloadpacket
        flops = trans = nbytes = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        if name in TRANSCENDENTAL:
            src = args[0] if name == "logsumexp" else out
            trans = sum(t.numel() for t in _tensors(src))
        if not func.is_view:
            nbytes = sum(_nbytes(t)
                         for t in _tensors((args, kwargs)) + _tensors(out))
        self._add(func, flops, trans, nbytes)
        if key is not None and (isinstance(out, torch.Tensor) or (
                isinstance(out, tuple) and out and all(
                    isinstance(t, torch.Tensor) for t in out))) \
                and not _shares_storage(out, (args, kwargs)):
            metas = [(tuple(t.shape), t.stride(), t.dtype)
                     for t in ((out,) if isinstance(out, torch.Tensor)
                               else out)]
            # a tuple of metas for a tuple output, a list for one tensor
            self._memo[key] = (tuple(metas) if isinstance(out, tuple)
                               else metas, flops, trans, nbytes)
        self._track(out)
        return out

    def _add(self, func, flops, trans, nbytes):
        if flops:
            self.flops += flops
            self.flops_by_op[str(func._overloadpacket)] += flops
        self.transcendentals += trans
        self.bytes_accessed += nbytes

    @staticmethod
    def _memo_key(func, types, args, kwargs):
        """A key for an op whose outputs depend on its inputs' metadata
        alone: a pure (no view, no mutation) op of meta tensors, whose
        output layouts, FLOPs and bytes the mode can replay without running
        it; None for any other op (factories among them: their device is
        an argument)."""
        if func.is_view or func._schema.is_mutable or any(
                issubclass(t, FakeTensor) for t in types):
            return None
        if func.namespace not in ("aten", "prims", "repro_torch"):
            return None
        parts = [func]
        tensors = 0
        for a in _leaves((args, kwargs)):
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                tensors += 1
                parts.append((tuple(a.shape), a.stride(), a.dtype))
            elif isinstance(a, torch.device):
                return None
            else:
                parts.append(a)
        if not tensors:
            return None
        try:
            hash(tuple(parts))
        except TypeError:
            return None
        return tuple(parts)


def _shares_storage(out, inputs) -> bool:
    """Whether an output of an op lies in an input's storage: an op the
    schema does not call a view (``aten._unsafe_view``) can return one, and
    a replay would allocate it anew."""
    ins = [t.untyped_storage() for t in _tensors(inputs)]
    return any(t.untyped_storage() is s for t in _tensors(out) for s in ins)


def local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``: a DTensor's local shard, a plain
    tensor whole."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks in this process: collectives
    return at once and move nothing.  Raises if a process group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count_cell(cell, mesh, *, warm: bool = False):
    """Run ``cell`` on ``mesh`` under a :class:`CostMode`; returns (mode,
    args, outputs).  ``warm`` runs it once first, so that DTensor's
    sharding cache holds every (op, placement) before the counted run."""
    args = tuple(distribute(a, s)
                 for a, s in zip(cell.args, cell.in_shardings))
    with use_mesh(mesh), torch.no_grad():
        if warm:
            cell.fn(*args)
        mode = CostMode()
        mode.hold(args)
        with mode:
            out = cell.fn(*args)
    return mode, args, out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             microbatches=None, verbose: bool = True,
             variant: str = "baseline"):
    reason = cell_is_supported(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    devices = 512 if multi_pod else 256
    with fake_world(devices):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = obs.now_ns()
        cell = build_cell(arch, shape_name, mesh, microbatches=microbatches,
                          variant=variant)
        mode, args, out = count_cell(cell, mesh)
        donate = cell.static_desc.get("donate", ())
        arg_bytes = mode.read_bytes(args)
        temp = mode.peak_bytes
        result = {
            "arch": arch,
            "shape": shape_name,
            "multi_pod": multi_pod,
            "variant": variant,
            "status": "ok",
            "kind": cell.static_desc["kind"],
            "microbatches": cell.static_desc.get("microbatches", 1),
            "seconds": round((obs.now_ns() - t0) / 1e9, 1),
            "devices": math.prod(int(s) for s in mesh.shape),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": local_bytes(out),
                "temp_bytes": temp,
                "alias_bytes": mode.read_bytes([args[i] for i in donate]),
                "peak_bytes_per_device": arg_bytes + temp,
            },
            "cost": {
                "flops": float(mode.flops),
                "transcendentals": float(mode.transcendentals),
                "bytes_accessed": float(mode.bytes_accessed),
            },
            "flops_by_op": dict(mode.flops_by_op),
            "collectives": mode.collectives,
            "collective_bytes_total": sum(
                v["bytes"] for v in mode.collectives.values()),
        }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} "
              f"({'2x16x16' if multi_pod else '16x16'}): OK "
              f"flops={result['cost']['flops']:.3e} "
              f"mem/dev={result['memory']['peak_bytes_per_device']/2**30:.2f}"
              f"GiB coll={result['collective_bytes_total']/2**20:.1f}MiB "
              f"({result['seconds']}s)", flush=True)
    return result


def map_cells(fn, cells, jobs: int = 1):
    """``fn(*cell)`` for each cell, in order: in this process for
    ``jobs=1``, else in a pool of ``jobs`` fresh processes (one cell each:
    a cell starts its own fake process group)."""
    if jobs <= 1:
        for c in cells:
            yield fn(*c)
        return
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        yield from pool.map(fn, *zip(*cells))


def _dry_one(arch, shape, mp, microbatches, variant, out):
    tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
    tag += "" if variant == "baseline" else f"__{variant}"
    try:
        res = run_cell(arch, shape, multi_pod=mp, microbatches=microbatches,
                       variant=variant)
    except Exception as e:  # noqa: BLE001 — record and continue
        traceback.print_exc()
        res = {"arch": arch, "shape": shape, "multi_pod": mp,
               "variant": variant, "status": "error", "error": repr(e)[:2000]}
    with open(os.path.join(out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=2)
    return res["status"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="artifacts/torch/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s, mp, args.microbatches, args.variant, args.out)
             for a in archs for s in shapes for mp in meshes]
    status = list(map_cells(_dry_one, cells, args.jobs))
    return 1 if "error" in status else 0


if __name__ == "__main__":
    sys.exit(main())
