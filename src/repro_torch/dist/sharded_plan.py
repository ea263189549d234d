"""``ShardedPlan`` — per-shard plans composed into one apply.

The distribution layer: when phase 1 is handed a ``mesh`` (or a
``partition``), the dataflow's :class:`repro_torch.dist.partition.
Partitioner` splits the block grid into one uniform sub-problem per shard,
each shard gets an ordinary :class:`repro_torch.api.FlexagonPlan` (or a
:class:`repro_torch.memory.TiledPlan` when its slice still exceeds the
memory budget — tiling stays orthogonal to placement), and
``ShardedPlan.apply`` runs them, on the ``cuda`` backend one K1/K2 launch
per shard with work:

- on the **collective** path — a process-group mesh (a 1-D
  ``torch.distributed.device_mesh.DeviceMesh``) with at least one rank per
  shard — rank ``r`` runs only ``plans[r]`` on its own device (an untiled
  plan, a :class:`repro_torch.memory.TiledPlan` or a mixed shard's plan
  alike), writes its result into a zero-filled (m, n) C (its disjoint
  region for ``m``/``n`` partitions, the whole C for OP's ``k`` slabs) and
  the ranks merge with one ``all_reduce(SUM)``.  Adding zeros is exact,
  so disjoint partitions come back bit for bit; every rank returns the
  whole C, as a JAX caller of ``shard_map`` gets it.  The one collective
  works on gloo (which takes ``all_reduce``, but not ``all_gather``, on
  CUDA tensors) and NCCL alike;
- otherwise (a single-process :class:`repro_torch.launch.mesh.Mesh`, no
  mesh, or fewer ranks than shards) on the **serial** path: the shards
  run one after another on the plan's device, and their results are
  summed in shard order (``k``) or concatenated (``m``/``n``).

Each shard runs on its slice of the operands at its real extent (the
part of its tile inside (m, k, n)), not on a zero-padded copy of the
whole padded grid, and a shard wholly in the padding runs nothing.

``apply`` records which path it ran: the ``dist.sharded.apply`` span
carries a ``path`` attribute, and each merge counts one
``dist.collectives``.

Phase 1 is byte-equal to the JAX package's ``repro.dist.sharded_plan``:
tiles, ``padded_grid``, per-shard dataflows, layouts, index plans and
backend schedules, ``shard_ok`` and the padded per-shard plans.  The JAX
package pads the shard plans to one shape so that they stack into one
``shard_map``; the port runs each rank's plan on its own and stacks
nothing, so the padding serves byte-equality only (ROADMAP lists it beside
the tiled plans' lane padding as a candidate for removal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..backends import get_backend
from ..backends.base import TABLE3_FORMATS
from ..core import dataflows as df
from ..core.formats import SparseFormat, blockize
from ..core.selector import DataflowEstimate, DeviceSpec, LayerShape, estimate
from ..launch.mesh import is_process_mesh, mesh_shape
from ..memory.budget import MemoryBudget, output_bytes
from ..memory.tiled_plan import (_build_sub_plan, _pack_bitmap, _pad_lane,
                                 _unpack_bitmap, plan_tiled)
from ..memory.tiling import Tile
from .partition import (DistPartition, Partitioner, merge_ici_bytes,
                        mesh_device_count, resolve_shards)

__all__ = ["ShardedPlan", "plan_sharded"]


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Phase-1 output for one SpMSpM partitioned across a mesh.

    Mirrors the :class:`repro_torch.api.FlexagonPlan` /
    :class:`repro_torch.memory.TiledPlan` surface (``apply`` /
    ``__call__`` / ``matches`` / ``with_backend`` / ``pack_a`` /
    ``pack_b`` …) so every caller of the plan API can hold any of the
    three.  ``tiles`` are the per-shard sub-grids (uniform half-open block
    ranges along the partition axis); ``ici_bytes`` is the priced
    cross-shard merge traffic (nonzero only for k-slab partitions, whose
    partial sums all-reduce across the mesh).  Every plan lives on
    ``device``: on a process-group mesh, each rank builds the whole plan on
    its own device and runs its own shard.
    """

    dataflow: str
    axis: str                                # "m" | "k" | "n"
    n_shards: int
    mesh: Any                                # Mesh, DeviceMesh or None
    partition: DistPartition
    tiles: Tuple[Tile, ...]                  # per-shard sub-grids
    plans: Tuple[Any, ...]                   # FlexagonPlan | TiledPlan each
    shapes: Tuple[int, int, int]
    block_shape: Tuple[int, int, int]
    padded_grid: Tuple[int, int, int]
    backend: str
    budget: Optional[MemoryBudget]
    fingerprint: str
    device: torch.device
    shard_ok: bool                           # untiled, padded shard plans
    ici_bytes: float
    occ_a_packed: Tuple[bytes, Tuple[int, int]]
    occ_b_packed: Tuple[bytes, Tuple[int, int]]

    # -- phase-1 byproducts ----------------------------------------------
    @property
    def is_mixed(self) -> bool:
        """Heterogeneous per-tile dataflows inside the shards."""
        return self.dataflow == "mixed"

    @property
    def out_major(self) -> str:
        if self.is_mixed:
            return "csr"       # dense-assembled disjoint regions
        return df.OUTPUT_MAJOR[self.dataflow]

    @property
    def formats(self):
        if self.is_mixed:
            return (SparseFormat.BCSR, SparseFormat.BCSR)
        return TABLE3_FORMATS[self.dataflow]

    @property
    def collective(self) -> str:
        """The cross-shard merge collective ("psum" for k-slab partitions,
        the JAX package's name for the sum that ``all_reduce`` runs)."""
        return "psum" if self.axis == "k" and self.n_shards > 1 else "none"

    @property
    def occ_a(self) -> np.ndarray:
        return _unpack_bitmap(self.occ_a_packed)

    @property
    def occ_b(self) -> np.ndarray:
        return _unpack_bitmap(self.occ_b_packed)

    @property
    def mesh_shape(self) -> Optional[Tuple[int, ...]]:
        return mesh_shape(self.mesh)

    @property
    def dist_stats(self) -> dict:
        """Shard/collective telemetry (surfaced by ``ServeEngine.stats``)."""
        return {"mesh_shape": self.mesh_shape, "shards": self.n_shards,
                "axis": self.axis, "collective": self.collective,
                "ici_bytes": float(self.ici_bytes)}

    @property
    def path(self) -> str:
        """"collective" when ``apply`` runs one shard per rank and merges
        with ``all_reduce``, else "serial" (module docstring)."""
        if is_process_mesh(self.mesh) \
                and mesh_device_count(self.mesh) >= self.n_shards:
            return "collective"
        return "serial"

    @property
    def estimate(self) -> DataflowEstimate:
        """Aggregate over shards (shards run in parallel, so ``compute_s`` /
        ``memory_s`` take the slowest shard; bytes sum)."""
        ests = [p.estimate for p in self.plans]
        return DataflowEstimate(
            dataflow=self.dataflow,
            flops=sum(e.flops for e in ests),
            bytes_a=sum(e.bytes_a for e in ests),
            bytes_b=sum(e.bytes_b for e in ests),
            bytes_c=sum(e.bytes_c for e in ests),
            bytes_psum=sum(e.bytes_psum for e in ests) + self.ici_bytes,
            compute_s=max(e.compute_s for e in ests),
            memory_s=max(e.memory_s for e in ests),
        )

    def matches(self, a, b) -> bool:
        """Do these operands carry the planned (whole-operation) pattern?"""
        from ..api import _fingerprint, _pattern_of

        (m, k), occ_a = _pattern_of(a, self.block_shape[:2])
        (_, n), occ_b = _pattern_of(b, self.block_shape[1:])
        return _fingerprint(occ_a, occ_b, (m, k, n),
                            self.block_shape) == self.fingerprint

    def with_backend(self, backend) -> "ShardedPlan":
        """Re-target onto another backend (re-partitions from the stored
        bitmaps so each substrate gets the plan shapes it expects).  Mixed
        plans re-target shard by shard instead — each shard's per-tile
        dataflow choices are pinned, never re-selected."""
        be = get_backend(backend)
        if self.is_mixed:
            plans = tuple(p.with_backend(be) for p in self.plans)
            return dataclasses.replace(self, backend=be.name, plans=plans,
                                       shard_ok=False)
        return plan_sharded(
            dataflow=self.dataflow, occ_a=self.occ_a, occ_b=self.occ_b,
            shapes=self.shapes, block_shape=self.block_shape, mesh=self.mesh,
            partition=DistPartition(axis=self.axis, shards=self.n_shards),
            budget=self.budget, backend=be, fingerprint=self.fingerprint,
            device=self.device)

    # -- packing (host-side conveniences, phase-1 style) ------------------
    def _pack(self, x, fmt, block_shape):
        from ..api import SparseOperand

        if isinstance(x, SparseOperand):
            x = x.todense()
        return SparseOperand.from_dense(x, format=fmt,
                                        block_shape=block_shape,
                                        device=self.device)

    def pack_a(self, a):
        """Whole-operand compression in the planned A format (shards ingest
        dense slices, so packing is a storage convenience here)."""
        return self._pack(a, self.formats[0], self.block_shape[:2])

    def pack_b(self, b):
        return self._pack(b, self.formats[1], self.block_shape[1:])

    # -- phase 2 ---------------------------------------------------------
    def _densify(self, x) -> torch.Tensor:
        from ..api import SparseOperand

        if isinstance(x, SparseOperand):
            x = x.todense()
        return torch.as_tensor(x, device=self.device).float()

    def apply(self, a, b, out_dtype=torch.float32) -> torch.Tensor:
        """Execute C = A @ B across the shards, with zero host-side plan
        work; on the collective path every rank returns the whole C."""
        path = self.path
        if obs.enabled():
            with obs.span("dist.sharded.apply", dataflow=self.dataflow,
                          shards=self.n_shards, axis=self.axis,
                          collective=self.collective,
                          ici_bytes=float(self.ici_bytes), path=path):
                return self._apply_inner(a, b, out_dtype, path)
        return self._apply_inner(a, b, out_dtype, path)

    def _apply_inner(self, a, b, out_dtype, path: str) -> torch.Tensor:
        from ..api import FlexagonPlan

        a_d = self._densify(a)
        b_d = self._densify(b)
        if any(isinstance(p, FlexagonPlan) for p in self.plans):
            # whole blocks of the real grid (a copy only where an operand
            # ends inside a block), so an untiled shard's slices are views;
            # tiled shards pad their own slices
            m, k, n = self.shapes
            bm, bk, bn = self.block_shape
            a_d = _pad_to(a_d, (-(-m // bm) * bm, -(-k // bk) * bk))
            b_d = _pad_to(b_d, (-(-k // bk) * bk, -(-n // bn) * bn))
        if path == "collective":
            out = self._apply_collective(a_d, b_d)
        else:
            out = self._apply_serial(a_d, b_d)
        return out.to(out_dtype)

    __call__ = apply

    def _extents(self, s: int):
        """Shard ``s``'s origin in the operands, (rows, depth, cols), and
        its real extent there: the part of its tile inside (m, k, n).  A
        shard that lies wholly in the grid's padding has a zero extent."""
        bm, bk, bn = self.block_shape
        t = self.tiles[s]
        origin = (t.i0 * bm, t.k0 * bk, t.j0 * bn)
        ends = (t.i1 * bm, t.k1 * bk, t.j1 * bn)
        return origin, tuple(max(0, min(e, full) - o) for o, e, full
                             in zip(origin, ends, self.shapes))

    def _shard_apply(self, s: int, a_d: torch.Tensor, b_d: torch.Tensor
                     ) -> Optional[torch.Tensor]:
        """Shard ``s``'s product over its real extent ``(rows, cols)``, or
        ``None`` for a shard that lies wholly in the grid's padding.

        A tiled shard takes its slices at their real extent and pads them
        itself.  An untiled one takes its operands compressed from views
        of whole blocks (``a_d``/``b_d`` then hold whole blocks of the
        real grid) at their real extent, so the kernels compute the rows a
        shard has (a 4-token shard: 4 rows, not a padded block's 128); a
        shard whose tile ends in blocks past the real grid takes its
        slices padded to the tile."""
        from ..api import FlexagonPlan

        (i0, k0, j0), real = self._extents(s)
        if min(real) == 0:
            return None
        plan = self.plans[s]
        vm, vk, vn = real
        if not isinstance(plan, FlexagonPlan):
            return plan.apply(a_d[i0:i0 + vm, k0:k0 + vk],
                              b_d[k0:k0 + vk, j0:j0 + vn],
                              torch.float32)[:vm, :vn]
        bm, bk, bn = self.block_shape
        t = self.tiles[s]
        tile = ((t.i1 - t.i0) * bm, (t.k1 - t.k0) * bk, (t.j1 - t.j0) * bn)
        # the real extents rounded up to whole blocks
        wm, wk, wn = (-(-r // b) * b for r, b in zip(real, self.block_shape))
        a_s = a_d[i0:i0 + wm, k0:k0 + wk]
        b_s = b_d[k0:k0 + wk, j0:j0 + wn]
        if (wm, wk, wn) == tile:
            shape = real
        else:
            shape = tile
            a_s = _pad_to(a_s, (tile[0], tile[1]))
            b_s = _pad_to(b_s, (tile[1], tile[2]))
        out = plan.apply(_compress_at(plan.a_layout, a_s, shape[:2]),
                         _compress_at(plan.b_layout, b_s, shape[1:]),
                         torch.float32)
        return out[:vm, :vn]

    def _apply_serial(self, a_d: torch.Tensor,
                      b_d: torch.Tensor) -> torch.Tensor:
        """Every shard on this device, one after another, then the
        combine: a sum in shard order for k-slabs, a concatenation for
        disjoint output partitions."""
        m, _, n = self.shapes
        parts = [p for p in (self._shard_apply(s, a_d, b_d)
                             for s in range(self.n_shards)) if p is not None]
        if not parts:
            return torch.zeros((m, n), dtype=torch.float32,
                               device=a_d.device)
        if self.axis == "k":
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return torch.cat(parts, dim=0 if self.axis == "m" else 1)

    def _apply_collective(self, a_d: torch.Tensor,
                          b_d: torch.Tensor) -> torch.Tensor:
        """This rank's shard, merged across the mesh by one
        ``all_reduce(SUM)`` of a zero-filled (m, n) C.  Ranks past
        ``n_shards``, and shards in the grid's padding, contribute
        zeros."""
        import torch.distributed as dist

        m, _, n = self.shapes
        rank = self.mesh.get_local_rank()
        out = torch.zeros((m, n), dtype=torch.float32, device=a_d.device)
        part = (self._shard_apply(rank, a_d, b_d)
                if rank < self.n_shards else None)
        if part is not None:
            (i0, _, j0), (vm, _, vn) = self._extents(rank)
            out[i0:i0 + vm, j0:j0 + vn] = part
        dist.all_reduce(out, op=dist.ReduceOp.SUM,
                        group=self.mesh.get_group())
        obs.get_registry().counter("dist.collectives").inc()
        return out


def _pad_to(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """``x`` zero-padded at its end to ``shape`` (``x`` itself if it
    already has it)."""
    if tuple(x.shape) == tuple(shape):
        return x
    return torch.nn.functional.pad(
        x, (0, shape[1] - x.shape[1], 0, shape[0] - x.shape[0]))


def _compress_at(layout, x: torch.Tensor, shape: Tuple[int, int]):
    """``layout``'s blocks of ``x`` (whole blocks, the layout's grid) as an
    operand of logical ``shape``, which may stop short of ``x`` inside
    its last blocks: an executor then computes only those rows and
    columns."""
    from ..api import SparseOperand

    data = blockize(x, layout.block_shape)[layout.rows_t, layout.cols_t]
    return SparseOperand(data, layout.indptr, layout.indices, tuple(shape),
                         layout.block_shape, layout.fmt)


def plan_sharded(*, dataflow: str, occ_a: np.ndarray, occ_b: np.ndarray,
                 shapes: Tuple[int, int, int],
                 block_shape: Tuple[int, int, int], mesh,
                 partition: Optional[DistPartition],
                 budget: Optional[MemoryBudget], backend, fingerprint: str,
                 device, spec: DeviceSpec = DeviceSpec(), policy=None
                 ) -> Optional[ShardedPlan]:
    """Phase 1 for the multi-shard case.

    Returns ``None`` when the (mesh, partition) pair resolves to a single
    shard — the caller then builds an ordinary single-shard plan.
    ``dataflow="mixed"`` shards row bands of the output grid and lets each
    shard hold its own per-tile dataflow mix (``policy`` prices the tiles).
    """
    part = Partitioner.for_dataflow(dataflow, partition)
    n_shards = resolve_shards(mesh, partition)
    if n_shards <= 1:
        return None

    from ..api import FlexagonPlan

    device = torch.device(device)
    mixed = dataflow == "mixed"
    if mixed and budget is None:
        raise ValueError("dataflow='mixed' requires a memory_budget")
    m, k, n = shapes
    bm, bk, bn = block_shape
    shard_slices = part.shard_bitmaps(occ_a, occ_b, n_shards)
    padded = part.padded_grid((occ_a.shape[0], occ_a.shape[1],
                               occ_b.shape[1]), n_shards)

    # one shared estimate + fingerprint for the shard plans, as the JAX
    # package keeps them (there: so the plans stack into one shard_map);
    # mixed shards keep per-shard estimates
    t0 = shard_slices[0][0]
    shared_est = None if mixed else estimate(
        LayerShape(m=(t0.i1 - t0.i0) * bm, k=(t0.k1 - t0.k0) * bk,
                   n=(t0.j1 - t0.j0) * bn,
                   density_a=float(occ_a.mean()) if occ_a.size else 0.0,
                   density_b=float(occ_b.mean()) if occ_b.size else 0.0,
                   block=tuple(block_shape)), dataflow, spec)

    plans: List[Any] = []
    tiled_any = False
    for idx, (tile, occ_at, occ_bt) in enumerate(shard_slices):
        shape_a = ((tile.i1 - tile.i0) * bm, (tile.k1 - tile.k0) * bk)
        shape_b = ((tile.k1 - tile.k0) * bk, (tile.j1 - tile.j0) * bn)
        sub = None
        if budget is not None:
            # tiling within the shard: placement stays orthogonal to tiling
            sub = plan_tiled(dataflow=dataflow, occ_a=occ_at, occ_b=occ_bt,
                             shapes=(shape_a[0], shape_a[1], shape_b[1]),
                             block_shape=tuple(block_shape), budget=budget,
                             backend=backend,
                             fingerprint=f"{fingerprint}/shard{idx}",
                             device=device, spec=spec, policy=policy)
        if sub is not None:
            tiled_any = True
        else:
            d = dataflow
            if mixed:
                # this shard's slice fits in one resident tile: its "mix"
                # is the policy's single choice for the slice
                from ..memory.tiled_plan import mixed_tile_dataflows

                d = mixed_tile_dataflows(
                    occ_at, occ_bt, tuple(block_shape), budget,
                    backend=backend, policy=policy, spec=spec,
                    fingerprint=f"{fingerprint}/shard{idx}",
                    tiles=[Tile(0, occ_at.shape[0], 0, occ_at.shape[1],
                                0, occ_bt.shape[1])], device=device)[0]
            sub = _build_sub_plan(
                d, occ_at, occ_bt, tuple(block_shape), backend,
                f"{fingerprint}/shard", device, spec, est=shared_est)
        plans.append(sub)

    shard_ok = False
    if not mixed and not tiled_any:
        # transposed (N-stationary) executors scatter on the dual grid
        oob = (t0.j1 - t0.j0) if dataflow.endswith("_n") \
            else (t0.i1 - t0.i0)
        plans, shard_ok = _pad_lane(plans, oob)

    plans = [dataclasses.replace(p, aux=backend.prepare(p))
             if isinstance(p, FlexagonPlan) and p.aux is None else p
             for p in plans]
    if shard_ok:
        # the shards' backend schedules padded to shared extents, as the
        # JAX package pads them to stack
        backend.uniform_aux(plans)

    dt = budget.dtype_bytes if budget is not None else 4
    c_bytes = output_bytes(occ_a, occ_b, (bm, bn), dt)
    ici = merge_ici_bytes(part.axis, n_shards, c_bytes)
    obs.get_registry().gauge("dist.ici_bytes").set(float(ici))

    return ShardedPlan(
        dataflow=dataflow, axis=part.axis, n_shards=n_shards, mesh=mesh,
        partition=partition if partition is not None else DistPartition(),
        tiles=tuple(t for t, _, _ in shard_slices), plans=tuple(plans),
        shapes=tuple(shapes), block_shape=tuple(block_shape),
        padded_grid=tuple(padded), backend=backend.name, budget=budget,
        fingerprint=fingerprint, device=device, shard_ok=shard_ok,
        ici_bytes=float(ici), occ_a_packed=_pack_bitmap(occ_a),
        occ_b_packed=_pack_bitmap(occ_b))
