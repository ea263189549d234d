"""Plan-once / execute-many Flexagon operator API.

The paper's architecture has two phases:

- **phase 1 (offline, host)** — the mapper/compiler inspects one SpMSpM
  operation's sparsity *pattern*, estimates every dataflow's cost, picks one,
  and configures the hardware (here: builds compression layouts and index
  plans, and uploads what the kernels read to the device);
- **phase 2 (online, device)** — the configured hardware executes, any number
  of times, on values that share the planned pattern.

This module makes the split explicit:

- :class:`SparseOperand` — one constructor/conversion surface over the four
  formats (``BCSR``/``BCSC`` block formats, ``CSR``/``CSC`` scalar formats);
- :func:`flexagon_plan` → :class:`FlexagonPlan` — phase 1 exactly once;
  ``plan.apply(a, b)`` (or ``plan(a, b)``) is phase 2: gathers through
  frozen device-side layouts and the planned executor, with no host-side
  plan building and no host→device copy of plan arrays;
- :class:`PlanCache` — fingerprint-keyed plan reuse for serving loops;
- :class:`FlexagonPipeline` — ``plan_network``-backed per-layer plan chain
  that keeps inter-layer activations in the producer's major order
  (Table 4 legality).

``backend=`` names the execution substrate (``reference`` / ``cuda`` /
``simulator``, or any registered
:class:`repro_torch.backends.ExecutionBackend`) and ``policy=`` the
dataflow-selection strategy (``heuristic`` / ``simulator`` / ``autotune``,
or any :class:`repro_torch.backends.SelectionPolicy`).  ``device=None``
runs on the card and raises without one; pass ``device="cpu"`` for the
plain versions.

``memory_budget=`` adds the paper's third pillar: when the pattern's
working set exceeds the on-chip :class:`repro_torch.memory.MemoryBudget`,
phase 1 tiles the operation with the dataflow's scheduler and returns a
:class:`repro_torch.memory.TiledPlan` — same ``apply`` surface, one kernel
launch per tile.  ``dataflow="mixed"`` makes the dataflow a per-tile
choice.

``mesh=`` / ``partition=`` add placement: phase 1 partitions the block grid
across a mesh (:mod:`repro_torch.launch.mesh`) with the dataflow's
strategy and returns a :class:`repro_torch.dist.ShardedPlan` — same
``apply`` contract; on a process-group mesh one shard per rank, merged by
one ``torch.distributed`` ``all_reduce``.

``verify=True`` (also the ``REPRO_VERIFY=1`` default) gates every plan
build behind :func:`repro_torch.analysis.verify_plan`.

``PHASE1_COUNTERS`` counts selector / layout / index-plan constructions so
tests (and profiles) can assert that execution never re-plans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import obs
from .backends import ExecutionBackend, get_backend
from .backends.base import TABLE3_FORMATS as _TABLE3_FORMATS
from .backends.base import allowed_dataflows
from .backends.policies import SelectionContext, SelectionPolicy, get_policy
from .config import resolve_device, resolve_verify
from .core import dataflows as df
from .core.formats import (
    CSC, CSR, BlockCSC, BlockCSR, SparseFormat, block_occupancy, blockize,
    dense_to_bcsc, dense_to_bcsr, to_host,
)
from .core.selector import (
    DataflowEstimate, DeviceSpec, LayerShape, estimate, plan_network,
    transition_needs_conversion,
)

__all__ = [
    "SparseFormat",
    "SparseOperand",
    "CompressionLayout",
    "FlexagonPlan",
    "flexagon_plan",
    "FlexagonPipeline",
    "PlanCache",
    "PHASE1_COUNTERS",
]

#: Phase-1 work counters — bumped ONLY while planning.  ``plan.apply`` must
#: leave them untouched (asserted by the tests).
PHASE1_COUNTERS = {"selector": 0, "layouts": 0, "index_plans": 0}

_BLOCK_CLS = {SparseFormat.BCSR: BlockCSR, SparseFormat.BCSC: BlockCSC}
_SCALAR_CLS = {SparseFormat.CSR: CSR, SparseFormat.CSC: CSC}


@dataclasses.dataclass
class SparseOperand:
    """A sparse matrix in one of the four formats.

    Block formats hold ``data`` as a torch tensor of ``(nnzb, bm, bk)``
    blocks on the operand's device and ``indptr``/``indices`` as host numpy
    arrays (the pattern is phase-1 data).  Scalar formats are numpy.
    """

    data: Any                       # (nnzb, bm, bk) blocks or (nnz,) scalars
    indptr: np.ndarray
    indices: np.ndarray
    shape: Tuple[int, int]
    block_shape: Optional[Tuple[int, int]]   # None for scalar formats
    fmt: SparseFormat

    # -- construction ----------------------------------------------------
    @classmethod
    def from_dense(cls, x, format: Union[str, SparseFormat] = SparseFormat.BCSR,
                   block_shape: Tuple[int, int] = (128, 128), *,
                   device=None) -> "SparseOperand":
        """Compress ``x``.  Block data lands on ``device``: by default a
        tensor's own device, else the card."""
        fmt = SparseFormat.of(format)
        if fmt.is_block:
            inner = (dense_to_bcsr if fmt is SparseFormat.BCSR
                     else dense_to_bcsc)(x, block_shape, device=device)
            return cls(inner.data, inner.indptr, inner.indices,
                       inner.shape, tuple(block_shape), fmt)
        inner = _SCALAR_CLS[fmt].from_dense(x)
        return cls(inner.data, inner.indptr, inner.indices,
                   inner.shape, None, fmt)

    @classmethod
    def wrap(cls, inner) -> "SparseOperand":
        """Adopt an existing BlockCSR/BlockCSC/CSR/CSC."""
        table = {BlockCSR: SparseFormat.BCSR, BlockCSC: SparseFormat.BCSC,
                 CSR: SparseFormat.CSR, CSC: SparseFormat.CSC}
        fmt = table[type(inner)]
        return cls(inner.data, inner.indptr, inner.indices, inner.shape,
                   getattr(inner, "block_shape", None)
                   if fmt.is_block else None, fmt)

    # -- views -----------------------------------------------------------
    def unwrap(self):
        """The underlying BlockCSR/BlockCSC/CSR/CSC instance."""
        if self.fmt.is_block:
            return _BLOCK_CLS[self.fmt](self.data, self.indptr, self.indices,
                                        self.shape, self.block_shape)
        return _SCALAR_CLS[self.fmt](self.data, self.indptr, self.indices,
                                     self.shape)

    def todense(self):
        return self.unwrap().todense()

    def convert(self, format: Union[str, SparseFormat],
                block_shape: Optional[Tuple[int, int]] = None
                ) -> "SparseOperand":
        """Re-express in another format (host-side; phase-1 work)."""
        fmt = SparseFormat.of(format)
        if fmt == self.fmt and (block_shape is None
                                or block_shape == self.block_shape):
            return self
        bs = block_shape or self.block_shape or (128, 128)
        dev = self.data.device if isinstance(self.data, torch.Tensor) \
            else "cpu"
        return SparseOperand.from_dense(self.todense(), format=fmt,
                                        block_shape=bs, device=dev)

    def bitmap(self) -> np.ndarray:
        """Block occupancy bitmap (block formats only)."""
        if not self.fmt.is_block:
            raise ValueError(f"{self.fmt} has no block bitmap")
        return self.unwrap().bitmap()

    # -- derived sizes ---------------------------------------------------
    @property
    def nnzb(self) -> int:
        """Stored element count (blocks for block formats, scalars else)."""
        return int(self.data.shape[0])

    nnz = nnzb

    @property
    def grid(self) -> Tuple[int, int]:
        if not self.fmt.is_block:
            raise ValueError(f"{self.fmt} has no block grid")
        return self.unwrap().grid

    @property
    def density(self) -> float:
        if self.fmt.is_block:
            mb, kb = self.grid
            return self.nnzb / max(1, mb * kb)
        return self.nnzb / max(1, self.shape[0] * self.shape[1])


# ---------------------------------------------------------------------------
# Compression layouts — pattern-frozen dense→compressed gathers
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class CompressionLayout:
    """Frozen block coordinate structure of one operand (phase-1 output).

    ``compress`` turns *new dense values with the planned pattern* into the
    planned block format with one device-side gather through ``rows_t`` /
    ``cols_t``, uploaded once when the layout is built.  Values outside the
    planned pattern are dropped (the pattern is the plan's contract).
    """

    rows: np.ndarray        # (nnzb,) block-row coordinate, fiber order
    cols: np.ndarray        # (nnzb,) block-col coordinate, fiber order
    indptr: np.ndarray      # (fibers+1,)
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    fmt: SparseFormat       # BCSR (row-major fibers) or BCSC (col-major)
    device: torch.device

    def __post_init__(self):
        self.rows_t = torch.as_tensor(self.rows, device=self.device).long()
        self.cols_t = torch.as_tensor(self.cols, device=self.device).long()

    @classmethod
    def from_bitmap(cls, occ: np.ndarray, shape, block_shape,
                    fmt: SparseFormat, device) -> "CompressionLayout":
        PHASE1_COUNTERS["layouts"] += 1
        if fmt is SparseFormat.BCSR:
            rows, cols = np.nonzero(occ)                  # row-major order
            fibers = occ.shape[0]
            counts = np.bincount(rows, minlength=fibers)
        else:
            cols_m, rows_m = np.nonzero(occ.T)            # column-major order
            rows, cols = rows_m, cols_m
            fibers = occ.shape[1]
            counts = np.bincount(cols, minlength=fibers)
        indptr = np.zeros(fibers + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return cls(rows.astype(np.int32), cols.astype(np.int32), indptr,
                   tuple(shape), tuple(block_shape), fmt,
                   torch.device(device))

    @property
    def nnzb(self) -> int:
        return int(self.rows.shape[0])

    @property
    def indices(self) -> np.ndarray:
        """The fiber coordinate list of the planned format."""
        return self.cols if self.fmt is SparseFormat.BCSR else self.rows

    def compress(self, x) -> SparseOperand:
        """Dense values -> planned block format, gathered on the device."""
        x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape) != tuple(self.shape):
            raise ValueError(f"operand shape {tuple(x.shape)} != planned "
                             f"{self.shape}")
        data = blockize(x, self.block_shape)[self.rows_t, self.cols_t]
        return SparseOperand(data, self.indptr, self.indices, self.shape,
                             self.block_shape, self.fmt)

    def skeleton(self) -> Any:
        """A pattern-only BlockCSR/BlockCSC (dummy 1×1 data blocks) for the
        host-side index-plan builders, which read structure only."""
        dummy = torch.zeros((self.nnzb, 1, 1))
        return _BLOCK_CLS[self.fmt](dummy, self.indptr, self.indices,
                                    self.shape, self.block_shape)


# ---------------------------------------------------------------------------
# FlexagonPlan — phase 1 exactly once
# ---------------------------------------------------------------------------

OperandSpec = Union[np.ndarray, torch.Tensor, SparseOperand, Tuple[int, int]]
BackendArg = Union[str, ExecutionBackend, None]
PolicyArg = Union[str, SelectionPolicy, None]


def _pattern_consistent(x: SparseOperand, layout: CompressionLayout) -> bool:
    """Does this operand's coordinate structure match the planned layout?

    A same-format, same-count operand with *different* coordinates would be
    multiplied against the wrong partners by the frozen index plan, so it
    must be re-compressed.  Operands packed by this layout share its arrays
    and pass on identity alone.
    """
    planned = layout.indices
    if x.indptr is layout.indptr and x.indices is planned:
        return True
    return (np.array_equal(np.asarray(x.indptr), layout.indptr)  # lint: host-ok
            and np.array_equal(np.asarray(x.indices), planned))  # lint: host-ok


def _pattern_of(spec: OperandSpec, block_shape: Tuple[int, int]
                ) -> Tuple[Tuple[int, int], np.ndarray]:
    """(logical shape, block occupancy bitmap) of an operand spec.

    A bare ``(m, k)`` shape tuple means "fully dense pattern" — the SpMM
    special case (e.g. dense activations) without materializing values.
    """
    if isinstance(spec, tuple):
        m, k = spec
        grid = (_ceil_div(m, block_shape[0]), _ceil_div(k, block_shape[1]))
        return (m, k), np.ones(grid, dtype=bool)
    if isinstance(spec, SparseOperand):
        if spec.fmt.is_block and tuple(spec.block_shape) == tuple(block_shape):
            return tuple(spec.shape), spec.bitmap()
        return (tuple(spec.shape),
                block_occupancy(spec.todense(), block_shape))
    x = to_host(spec)
    return x.shape, block_occupancy(x, block_shape)


def _fingerprint(occ_a: np.ndarray, occ_b: np.ndarray,
                 shapes: Tuple[int, int, int],
                 block_shape: Tuple[int, int, int]) -> str:
    h = hashlib.sha1()
    h.update(repr((shapes, block_shape, occ_a.shape, occ_b.shape)).encode())
    h.update(np.packbits(occ_a).tobytes())
    h.update(np.packbits(occ_b).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class FlexagonPlan:
    """Everything phase 1 produced for one SpMSpM pattern.

    ``apply(a, b)`` / ``plan(a, b)`` executes with zero host-side plan
    building: operands (dense tensors or :class:`SparseOperand` in the
    planned formats) are ingested through frozen gathers on ``device`` and
    handed to the planned backend's ``execute``.

    ``backend`` is a registry *name* (``reference``/``cuda``/custom) — the
    live :class:`repro_torch.backends.ExecutionBackend` is resolved per
    call.  ``aux`` holds whatever the backend's ``prepare`` built for this
    pattern (e.g. the cuda backend's device-side work list).
    """

    dataflow: str
    a_layout: CompressionLayout
    b_layout: CompressionLayout
    index_plan: Any                      # IPPlan | StreamPlan (numpy)
    aux: Any                             # backend prepare() output
    estimate: DataflowEstimate
    fingerprint: str
    shapes: Tuple[int, int, int]         # (m, k, n)
    block_shape: Tuple[int, int, int]
    backend: str                         # registry name
    device: torch.device

    # -- phase-1 byproducts ----------------------------------------------
    @property
    def out_major(self) -> str:
        """Output major order, paper Table 3 (csr for _m, csc for _n)."""
        return df.OUTPUT_MAJOR[self.dataflow]

    @property
    def formats(self) -> Tuple[SparseFormat, SparseFormat]:
        """Planned (A, B) operand formats, paper Table 3."""
        return _TABLE3_FORMATS[self.dataflow]

    def pack_a(self, a) -> SparseOperand:
        """Compress A values into the planned format (reusable across calls)."""
        return self._ingest(a, self.a_layout, "a")

    def pack_b(self, b) -> SparseOperand:
        return self._ingest(b, self.b_layout, "b")

    def matches(self, a: OperandSpec, b: OperandSpec) -> bool:
        """Host-side check: do these operands carry the planned pattern?"""
        (m, k), occ_a = _pattern_of(a, self.block_shape[:2])
        (k2, n), occ_b = _pattern_of(b, self.block_shape[1:])
        return _fingerprint(occ_a, occ_b, (m, k, n),
                            self.block_shape) == self.fingerprint

    # -- phase 2 ---------------------------------------------------------
    def _ingest(self, x, layout: CompressionLayout,
                operand: str) -> SparseOperand:
        """``x`` in the planned format: as it is where it already is, else
        gathered through ``layout`` under a ``plan.apply.ingest`` span."""
        if isinstance(x, SparseOperand):
            if x.fmt == layout.fmt and x.block_shape == layout.block_shape \
                    and x.nnzb == layout.nnzb \
                    and _pattern_consistent(x, layout):
                return x
            x = x.todense()
        with obs.span("plan.apply.ingest", operand=operand):
            return layout.compress(x)

    def apply(self, a, b, out_dtype=torch.float32) -> torch.Tensor:
        """Execute C = A @ B on the planned pattern.

        A dense B that the backend reads in place
        (:meth:`repro_torch.backends.ExecutionBackend.reads_b_in_place`: on
        ``cuda``, an fp32 B of an M-stationary kernel plan) goes to it as it
        is; every other B is ingested into the planned format.

        While tracing is on the call runs under a ``plan.apply`` span
        (``dataflow``; ``route``, the backend's name until the backend
        names what it ran: ``k1``/``k2``/``escape`` on ``cuda``; ``b_ingest``,
        ``in_place`` or ``gather``: B handed over dense, or as blocks) with
        ``plan.apply.ingest`` children for the operands it gathers and the
        backend's own.
        """
        with obs.span("plan.apply", dataflow=self.dataflow,
                      route=self.backend):
            backend = get_backend(self.backend)
            a_c = self._ingest(a, self.a_layout, "a").unwrap()
            if backend.reads_b_in_place(self, b):
                obs.annotate(b_ingest="in_place")
                b_c = b
            else:
                obs.annotate(b_ingest="gather")
                b_c = self._ingest(b, self.b_layout, "b").unwrap()
            return backend.execute(self, a_c, b_c, out_dtype)

    __call__ = apply

    def with_backend(self, backend: BackendArg) -> "FlexagonPlan":
        """Re-target this plan onto another backend (phase-1 aux rebuilt).

        Layouts, index plan and dataflow choice are shared — only the
        substrate-specific ``aux`` is re-prepared.
        """
        be = get_backend(backend)
        if not be.supports(self.dataflow, *_TABLE3_FORMATS[self.dataflow],
                           tuple(self.block_shape)):
            raise ValueError(
                f"backend {be.name!r} does not support {self.dataflow!r} "
                f"at block_shape={tuple(self.block_shape)}")
        plan = dataclasses.replace(self, backend=be.name, aux=None)
        return dataclasses.replace(plan, aux=be.prepare(plan))


def _build_index_plan(dataflow: str, a_layout: CompressionLayout,
                      b_layout: CompressionLayout):
    """Index plans per Table 3, on pattern-only skeletons.

    N-stationary plans are built for the transposed problem, matching how
    the executors run them (C = (Bᵀ Aᵀ)ᵀ).
    """
    PHASE1_COUNTERS["index_plans"] += 1
    a_s, b_s = a_layout.skeleton(), b_layout.skeleton()
    if dataflow == "ip_m":
        return df.build_ip_plan(a_s, b_s)
    if dataflow == "op_m":
        return df.build_op_plan(a_s, b_s)
    if dataflow == "gust_m":
        return df.build_gust_plan(a_s, b_s)
    if dataflow == "ip_n":
        return df.build_ip_plan(df._transpose_bcsr_of(b_s),
                                df._transpose_bcsc_of(a_s))
    if dataflow == "op_n":
        return df.build_op_plan(df._transpose_bcsc_of(b_s),
                                df._transpose_bcsr_of(a_s))
    if dataflow == "gust_n":
        return df.build_gust_plan(df._transpose_bcsr_of(b_s),
                                  df._transpose_bcsr_of(a_s))
    raise ValueError(f"unknown dataflow {dataflow!r}")


def _resolve_backend(backend: BackendArg) -> ExecutionBackend:
    return get_backend("reference" if backend is None else backend)


def flexagon_plan(a_spec: OperandSpec, b_spec: OperandSpec, *,
                  dataflow: str = "auto",
                  block_shape: Tuple[int, int, int] = (128, 128, 128),
                  spec: DeviceSpec = DeviceSpec(),
                  backend: BackendArg = None,
                  policy: PolicyArg = None,
                  device=None,
                  memory_budget: Optional[Any] = None,
                  mesh: Optional[Any] = None,
                  partition: Optional[Any] = None,
                  tile_dataflows: Optional[Tuple[str, ...]] = None,
                  verify: Optional[bool] = None) -> FlexagonPlan:
    """Phase 1, exactly once: inspect patterns, select, lay out, configure.

    ``a_spec``/``b_spec`` describe *patterns*: dense arrays or tensors
    (pattern from values), :class:`SparseOperand`, or a bare ``(m, k)``
    shape tuple for a fully dense operand.  The returned plan executes any
    values sharing the pattern — see :meth:`FlexagonPlan.apply`.

    ``backend`` picks the execution substrate (``"reference"`` default,
    ``"cuda"``, ``"simulator"``, or a registered custom backend); ``policy``
    the selection strategy (``"heuristic"`` default, ``"simulator"``,
    ``"autotune"``, or a ``SelectionPolicy``).  An explicit ``dataflow=``
    pins the choice and bypasses the policy.  ``device=None`` resolves to
    the card (and raises without one).

    ``memory_budget`` (a :class:`repro_torch.memory.MemoryBudget`) bounds
    the on-chip working set: a pattern that exceeds it is partitioned by
    the chosen dataflow's tile scheduler and a
    :class:`repro_torch.memory.TiledPlan` is returned instead (same
    ``apply`` contract).  Policies see the budget in their
    :class:`SelectionContext` and rank dataflows by tiled traffic.

    ``dataflow="mixed"`` (requires a ``memory_budget``) makes dataflow a
    *per-tile* decision: the mixed scheduler tiles the output grid into
    disjoint C regions and the policy's ``select_tile`` picks each tile's
    dataflow on the tile's own occupancy slice.  A pattern that fits in one
    resident tile degenerates to the policy's choice for that single tile.
    ``tile_dataflows`` pins the mixed per-tile choices outright, skipping
    the policy (callers that already ran the selection — ``PlanCache``).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh` or a 1-D
    ``DeviceMesh``) makes placement part of phase 1: the dataflow's
    :class:`repro_torch.dist.Partitioner` splits the block grid into one
    sub-problem per shard and a :class:`repro_torch.dist.ShardedPlan` is
    returned — same ``apply`` contract.  ``partition`` (a
    :class:`repro_torch.dist.DistPartition`) overrides the strategy's axis
    or shard count; tiling under ``memory_budget`` then happens *within*
    each shard.  With ``device=None`` a single-process mesh's plans go to
    the mesh's device.

    ``verify`` gates the returned plan behind
    :func:`repro_torch.analysis.verify_plan` — structural invariants
    (coverage, merge compatibility, pad validity, backend capability,
    fingerprint agreement, and on ``cuda`` the schedule and the device
    tables the kernels read) are re-derived from the built plan and an
    error-severity violation raises
    :class:`repro_torch.analysis.PlanVerificationError` instead of handing
    out a corrupt plan.  ``None`` defers to ``REPRO_VERIFY`` (on in the
    test suite, off otherwise).

    Phase 1 is observable (:mod:`repro_torch.obs`): the build runs under a
    ``plan.phase1`` span when ``REPRO_TRACE`` is on, with the children
    ``plan.pattern`` (both operands' block occupancy), ``plan.select`` and,
    for an untiled, unsharded plan, ``plan.tables`` and ``plan.prepare``;
    a tiled build lays out and prepares its tiles under ``plan.schedule``
    instead, a sharded one inside :func:`repro_torch.dist.plan_sharded`.  It
    counts into ``plan.builds``, ``plan.dataflow.<chosen>`` and the
    histogram ``plan.build_s``, whose stages are ``plan.pattern_s``,
    ``policy.select_s``, ``plan.tables_s`` and ``plan.prepare_s``.
    """
    dev = _resolve_plan_device(device, mesh)
    t0 = obs.now_ns()
    with obs.span("plan.phase1", dataflow=dataflow) as sp:
        plan = _plan_phase1(a_spec, b_spec, dataflow=dataflow,
                            block_shape=tuple(block_shape), spec=spec,
                            backend=backend, policy=policy, device=dev,
                            memory_budget=memory_budget, mesh=mesh,
                            partition=partition,
                            tile_dataflows=tile_dataflows)
        _maybe_verify(plan, verify)
        sp.set(chosen=plan.dataflow, kind=type(plan).__name__,
               backend=plan.backend)
    reg = obs.get_registry()
    reg.counter("plan.builds").inc()
    reg.counter(f"plan.dataflow.{plan.dataflow}").inc()
    reg.histogram("plan.build_s").observe((obs.now_ns() - t0) / 1e9)
    return plan


@contextlib.contextmanager
def _stage(span_name: str, histogram: str, **attrs):
    """A phase-1 stage: a span, and its seconds into ``histogram``."""
    t0 = obs.now_ns()
    with obs.span(span_name, **attrs):
        yield
    obs.get_registry().histogram(histogram).observe((obs.now_ns() - t0) / 1e9)


def _maybe_verify(plan, verify: Optional[bool]) -> None:
    """The pre-execution gate: verify a freshly built plan when asked.

    Runs only at build time — cache *hits* hand back plans that already
    passed (re-verifying per hit would put host work on the serving path).
    """
    if resolve_verify(verify):
        from .analysis.verify import verify_plan   # lazy: analysis uses api

        verify_plan(plan, raise_on_error=True)


def _resolve_plan_device(device, mesh) -> torch.device:
    """``device``, or for ``None`` a single-process mesh's own device, a
    process-group mesh's device on this rank (``cuda:{current}``), or the
    card."""
    from .launch.mesh import Mesh, is_process_mesh, process_mesh_device

    if device is None and isinstance(mesh, Mesh):
        return mesh.device
    if device is None and is_process_mesh(mesh):
        return process_mesh_device(mesh)
    return resolve_device(device)


def _plan_phase1(a_spec: OperandSpec, b_spec: OperandSpec, *, dataflow: str,
                 block_shape: Tuple[int, int, int], spec: DeviceSpec,
                 backend: BackendArg, policy: PolicyArg,
                 device: torch.device,
                 memory_budget: Optional[Any] = None,
                 mesh: Optional[Any] = None,
                 partition: Optional[Any] = None,
                 tile_dataflows: Optional[Tuple[str, ...]] = None):
    """:func:`flexagon_plan` body (the public wrapper adds the obs seam)."""
    bm, bk, bn = block_shape
    with _stage("plan.pattern", "plan.pattern_s"):
        (m, k), occ_a = _pattern_of(a_spec, (bm, bk))
        (k2, n), occ_b = _pattern_of(b_spec, (bk, bn))
    if k != k2:
        raise ValueError(f"inner dims disagree: A is {(m, k)}, B is {(k2, n)}")

    backend_obj = _resolve_backend(backend)
    policy_obj = get_policy(policy, dataflow)
    fingerprint = _fingerprint(occ_a, occ_b, (m, k, n), block_shape)
    shape = LayerShape(m=m, k=k, n=n,
                       density_a=float(occ_a.mean()),
                       density_b=float(occ_b.mean()),
                       block=block_shape)

    # capability negotiation: the policy only sees dataflows the backend
    # declares it can run at this block shape
    allowed = allowed_dataflows(backend_obj, block_shape)
    if not allowed:
        raise ValueError(f"backend {backend_obj.name!r} supports no dataflow "
                         f"at block_shape={block_shape}")
    mixed = dataflow == "mixed"
    if mixed and memory_budget is None:
        raise ValueError(
            "dataflow='mixed' requires a memory_budget: per-tile dataflow "
            "choice lives at the tiling seam")
    if dataflow == "auto" or mixed:
        PHASE1_COUNTERS["selector"] += 1
    elif dataflow not in df.DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    ctx = SelectionContext(shape=shape, block_shape=block_shape,
                           occ_a=occ_a, occ_b=occ_b, fingerprint=fingerprint,
                           backend=backend_obj, spec=spec, allowed=allowed,
                           memory_budget=memory_budget, mesh=mesh,
                           partition=partition, device=device)
    if not mixed:
        with _stage("plan.select", "policy.select_s",
                    policy=type(policy_obj).__name__):
            dataflow = policy_obj.select(ctx)

    if mesh is not None or partition is not None:
        from .dist.sharded_plan import plan_sharded   # lazy: dist uses api

        sharded = plan_sharded(dataflow=dataflow, occ_a=occ_a, occ_b=occ_b,
                               shapes=(m, k, n), block_shape=block_shape,
                               mesh=mesh, partition=partition,
                               budget=memory_budget, backend=backend_obj,
                               fingerprint=fingerprint, device=device,
                               spec=spec, policy=policy_obj)
        if sharded is not None:
            return sharded

    if memory_budget is not None:
        from .memory.tiled_plan import plan_tiled   # lazy: memory uses api

        tiled = plan_tiled(dataflow=dataflow, occ_a=occ_a, occ_b=occ_b,
                           shapes=(m, k, n), block_shape=block_shape,
                           budget=memory_budget, backend=backend_obj,
                           fingerprint=fingerprint, device=device, spec=spec,
                           policy=policy_obj,
                           tile_dataflows=tile_dataflows if mixed else None)
        if tiled is not None:
            return tiled

    if mixed:
        # the whole pattern fits in one resident tile — nothing to mix;
        # degenerate to the policy's choice for that single tile (the same
        # call PlanCache keys mixed plans by, so the cache identity and the
        # built plan can never disagree)
        if tile_dataflows:
            dataflow = tile_dataflows[0]
        else:
            from .memory.tiled_plan import mixed_tile_dataflows

            dataflow = mixed_tile_dataflows(
                occ_a, occ_b, block_shape, memory_budget,
                backend=backend_obj, policy=policy_obj, spec=spec,
                fingerprint=fingerprint, device=device)[0]

    fmt_a, fmt_b = _TABLE3_FORMATS[dataflow]
    with _stage("plan.tables", "plan.tables_s", dataflow=dataflow):
        a_layout = CompressionLayout.from_bitmap(occ_a, (m, k), (bm, bk),
                                                 fmt_a, device)
        b_layout = CompressionLayout.from_bitmap(occ_b, (k, n), (bk, bn),
                                                 fmt_b, device)
        index_plan = _build_index_plan(dataflow, a_layout, b_layout)

    plan = FlexagonPlan(
        dataflow=dataflow,
        a_layout=a_layout,
        b_layout=b_layout,
        index_plan=index_plan,
        aux=None,
        estimate=estimate(shape, dataflow, spec),
        fingerprint=fingerprint,
        shapes=(m, k, n),
        block_shape=block_shape,
        backend=backend_obj.name,
        device=device,
    )
    # "configure the hardware": backend-specific pattern-only schedules
    with _stage("plan.prepare", "plan.prepare_s", backend=backend_obj.name):
        return dataclasses.replace(plan, aux=backend_obj.prepare(plan))


# ---------------------------------------------------------------------------
# PlanCache — fingerprint-keyed plan reuse (serving loops)
# ---------------------------------------------------------------------------


class PlanCache:
    """Memoizes :func:`flexagon_plan` by pattern fingerprint, LRU-bounded.

    Serving loops see the same sparsity patterns over and over (weights are
    fixed; activation patterns are shape-only); the cache turns repeat
    phase-1 requests into dictionary hits.  ``maxsize=None`` (default)
    keeps every plan; a bound evicts the least-recently-used plan.
    ``hits`` / ``misses`` / ``evictions`` counters (and the ``stats`` view)
    surface cache behaviour to telemetry.
    """

    def __init__(self, spec: DeviceSpec = DeviceSpec(),
                 maxsize: Optional[int] = None):
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 or None, got {maxsize}")
        self.spec = spec
        self.maxsize = maxsize
        self._plans: "OrderedDict[Tuple, Any]" = OrderedDict()
        #: per-tile-choices memo for mixed lookups: repeat hits must not
        #: re-run the mixed schedule + per-tile selection.  LRU-bounded so
        #: a stream of distinct patterns (or per-request policy instances,
        #: which the identity-hashed key pins alive) cannot grow it — nor
        #: hold dead policies — without limit
        self._mixed_choices: "OrderedDict[Tuple, Tuple[str, ...]]" = \
            OrderedDict()
        self._mixed_choices_cap = maxsize if maxsize is not None else 1024
        self.hits = 0
        self.builds = 0
        self.evictions = 0

    @property
    def misses(self) -> int:
        """Cache misses == plans built."""
        return self.builds

    @property
    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._plans),
                "maxsize": self.maxsize}

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, a_spec: OperandSpec, b_spec: OperandSpec, *,
            dataflow: str = "auto",
            block_shape: Tuple[int, int, int] = (128, 128, 128),
            backend: BackendArg = None, policy: PolicyArg = None,
            device=None,
            memory_budget: Optional[Any] = None,
            mesh: Optional[Any] = None,
            partition: Optional[Any] = None,
            verify: Optional[bool] = None):
        # ``verify`` gates plan *builds* only (misses); hits return plans
        # that already passed, keeping verification off the serving path.
        # It is deliberately not part of the cache key — a verified and an
        # unverified build of the same pattern are the same plan.
        from .dist.partition import mesh_key   # lazy: dist uses api
        from .launch.mesh import mesh_placement

        dev = _resolve_plan_device(device, mesh)
        bm, bk, bn = block_shape
        (m, k), occ_a = _pattern_of(a_spec, (bm, bk))
        (_, n), occ_b = _pattern_of(b_spec, (bk, bn))
        backend_obj = _resolve_backend(backend)
        policy_obj = get_policy(policy, dataflow)
        fingerprint = _fingerprint(occ_a, occ_b, (m, k, n),
                                   tuple(block_shape))
        policy_key: Any = policy_obj.cache_key
        choices: Optional[Tuple[str, ...]] = None
        if dataflow == "mixed" and memory_budget is not None \
                and mesh is None and partition is None:
            # mixed identity is the policy's *per-tile choices*: two
            # policies that agree tile-by-tile share one plan.  Memoized so
            # repeat lookups skip the mixed schedule + per-tile selection
            from .memory.tiled_plan import mixed_tile_dataflows  # lazy

            # the memo holds the policy *object* (identity-hashed): a
            # string key could collide across short-lived instances, and
            # the strong reference keeps each instance's choices its own
            memo_key = (fingerprint, memory_budget, backend_obj.name,
                        policy_obj, str(dev))
            choices = self._mixed_choices.get(memo_key)
            if choices is None:
                choices = mixed_tile_dataflows(
                    occ_a, occ_b, tuple(block_shape), memory_budget,
                    backend=backend_obj, policy=policy_obj, spec=self.spec,
                    fingerprint=fingerprint, device=dev)
                self._mixed_choices[memo_key] = choices
                if len(self._mixed_choices) > self._mixed_choices_cap:
                    self._mixed_choices.popitem(last=False)
            else:
                self._mixed_choices.move_to_end(memo_key)
            policy_key = ("mixed-tiles",) + choices
        # the mesh *shape* (device grid + axis names), its kind and process
        # group, and the partition spec are part of the plan's identity: a
        # plan sharded for one mesh must never be served for another
        key = (fingerprint, dataflow, backend_obj.name, policy_key, str(dev),
               memory_budget, mesh_key(mesh), mesh_placement(mesh),
               partition)
        plan = self._plans.get(key)
        if plan is None:
            plan = flexagon_plan(a_spec, b_spec, dataflow=dataflow,
                                 block_shape=block_shape, spec=self.spec,
                                 backend=backend_obj, policy=policy_obj,
                                 device=dev, memory_budget=memory_budget,
                                 mesh=mesh, partition=partition,
                                 tile_dataflows=choices, verify=verify)
            self._plans[key] = plan
            self.builds += 1
            obs.get_registry().counter("cache.misses").inc()
            if self.maxsize is not None and len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
                self.evictions += 1
                obs.get_registry().counter("cache.evictions").inc()
        else:
            self.hits += 1
            obs.get_registry().counter("cache.hits").inc()
            self._plans.move_to_end(key)
        return plan


# ---------------------------------------------------------------------------
# FlexagonPipeline — plan_network over a layer chain (Table 4)
# ---------------------------------------------------------------------------


class FlexagonPipeline:
    """Per-layer plans chained through Table 4 format-transition legality.

    Phase 1 runs :func:`repro_torch.core.selector.plan_network` over the
    whole chain (a DP that charges explicit conversions), then builds one
    :class:`FlexagonPlan` (or, over a memory budget,
    :class:`repro_torch.memory.TiledPlan`) per layer with the planned
    dataflow.  ``apply(x)`` runs the chain; activations between layers keep
    the producer's major order — consumers whose Table 4 transition is
    legal ingest it directly through their frozen layout, and only ``EC``
    cells (counted in ``n_conversions``) imply a reorder.
    """

    def __init__(self, plans: List[Any], weights: List[SparseOperand],
                 dataflows: List[str], conversions: List[bool]):
        self.plans = plans
        self.weights = weights
        self.dataflows = dataflows
        self.conversions = conversions

    @classmethod
    def from_weights(cls, weights: Sequence[Any], *, tokens: int,
                     block_shape: Tuple[int, int, int] = (128, 128, 128),
                     spec: DeviceSpec = DeviceSpec(),
                     dataflows: Optional[Sequence[str]] = None,
                     backend: BackendArg = None,
                     policy: PolicyArg = None,
                     device=None,
                     memory_budget: Optional[Any] = None,
                     mesh: Optional[Any] = None,
                     partition: Optional[Any] = None
                     ) -> "FlexagonPipeline":
        """Plan a chain ``x → x@W1 → (x@W1)@W2 → …`` (phase 1 once).

        ``weights`` are dense arrays or tensors or :class:`SparseOperand`;
        layer i's K dim must equal layer i-1's N dim.  ``policy`` prices the
        per-layer candidates inside the ``plan_network`` DP (Table 4
        conversion penalties stay); ``backend`` is the substrate every
        layer plan targets, on ``device``.  ``memory_budget`` threads the
        on-chip capacity through the whole chain: the DP prices each
        (layer, dataflow) cell at its *tiled* cost and any over-budget layer
        plans into a :class:`repro_torch.memory.TiledPlan`.
        ``mesh``/``partition`` place every layer plan on the mesh (each
        becomes a :class:`repro_torch.dist.ShardedPlan`).
        """
        dev = _resolve_plan_device(device, mesh)
        bm, bk, bn = block_shape
        backend_obj = _resolve_backend(backend)
        policy_obj = get_policy(policy)
        shapes = []
        for i, w in enumerate(weights):
            (kw, nw), occ = _pattern_of(w, (bk, bn))
            if i > 0 and kw != shapes[-1].n:
                raise ValueError(
                    f"layer {i}: K={kw} != previous layer N={shapes[-1].n}")
            shapes.append(LayerShape(m=tokens, k=kw, n=nw, density_a=1.0,
                                     density_b=float(occ.mean()),
                                     block=tuple(block_shape)))
        if dataflows is None:
            PHASE1_COUNTERS["selector"] += 1
            dataflows = plan_network(
                shapes, spec,
                layer_cost=lambda l, d: policy_obj.layer_cost(
                    l, d, spec, memory_budget=memory_budget))
        dataflows = list(dataflows)

        plans, packed = [], []
        for w, s, d in zip(weights, shapes, dataflows):
            plan = flexagon_plan((tokens, s.k), w, dataflow=d,
                                 block_shape=block_shape, spec=spec,
                                 backend=backend_obj, device=dev,
                                 memory_budget=memory_budget, mesh=mesh,
                                 partition=partition)
            plans.append(plan)
            packed.append(plan.pack_b(w))
        conversions = [False] + [
            transition_needs_conversion(dataflows[i - 1], dataflows[i])
            for i in range(1, len(dataflows))]
        return cls(plans, packed, dataflows, conversions)

    @property
    def n_conversions(self) -> int:
        """Explicit conversions (Table 4 "EC" cells) along the chain."""
        return sum(self.conversions)

    @property
    def majors(self) -> List[str]:
        """Activation major order after each layer (Table 3)."""
        return [p.out_major for p in self.plans]

    def apply(self, x) -> torch.Tensor:
        """Run all layers, with zero host-side plan work."""
        for plan, w in zip(self.plans, self.weights):
            x = plan.apply(x, w)
        return x

    __call__ = apply
