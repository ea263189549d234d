"""The six SpMSpM dataflows (paper §2.2, Table 3) over block-sparse operands.

``C[M,N] = A[M,K] @ B[K,N]`` via three loop orders × two stationarity variants:

=========  =============  ==========  =========  =========  =========
loop       name           stationary  A format   B format   C format
=========  =============  ==========  =========  =========  =========
MNK        ip_m           C (fiber A) BCSR       BCSC       CSR-major
KMN        op_m           A           BCSC       BCSR       CSR-major
MKN        gust_m         A (fiber C) BCSR       BCSR       CSR-major
NMK        ip_n           C (fiber B) BCSR       BCSC       CSC-major
KNM        op_n           B           BCSC       BCSR       CSC-major
NKM        gust_n         B (fiber C) BCSC       BCSC       CSC-major
=========  =============  ==========  =========  =========  =========

The plan builders are numpy (phase 1) and build arrays byte-equal to
``repro.core.dataflows``.  The executors are the *torch reference*: eager
gathers, batched block products and an ``index_add_`` merge, whose
structure mirrors the hardware dataflow:

- **IP**: per C block, co-iterate the *intersection* of the A-row and B-column
  fibers; full sums only, no psum traffic.
- **OP**: K outermost; every k produces a rank-1 (block) update accumulated
  into C (the paper's merge phase).
- **Gust**: row-by-row leader-follower — each nonzero A element gathers the
  whole matching B fiber.

All six compute the same C up to float reassociation.  ``index_add_`` on a
CUDA tensor sums with atomics in no fixed order, so results match the JAX
reference to fp32 tolerance (``rtol=atol=1e-4`` in the tests), not bit for
bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .formats import BlockCSR, BlockCSC, dense_to_bcsr, dense_to_bcsc

__all__ = [
    "IPPlan",
    "StreamPlan",
    "build_ip_plan",
    "build_op_plan",
    "build_gust_plan",
    "ip_m",
    "op_m",
    "gust_m",
    "ip_n",
    "op_n",
    "gust_n",
    "run_dataflow",
    "DATAFLOWS",
    "OUTPUT_MAJOR",
]

DATAFLOWS = ("ip_m", "op_m", "gust_m", "ip_n", "op_n", "gust_n")

#: Output layout per dataflow (paper Table 3): M-stationary → row-major (CSR),
#: N-stationary → column-major (CSC).  Drives inter-layer format legality.
OUTPUT_MAJOR = {
    "ip_m": "csr", "op_m": "csr", "gust_m": "csr",
    "ip_n": "csc", "op_n": "csc", "gust_n": "csc",
}


# ---------------------------------------------------------------------------
# Plans — host-side, numpy.  ``to(device)`` makes the executor's copy.
# ---------------------------------------------------------------------------


def _on(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``; no copy when it already is one."""
    return torch.as_tensor(x, device=device)


@dataclasses.dataclass(frozen=True)
class IPPlan:
    """Per-C-block intersection lists, padded to the max intersection length.

    pair_a/pair_b: (Mb, Nb, P) int32 slots into A.data / B.data.
    npairs:        (Mb, Nb) int32 — number of valid pairs per C block.
    """

    pair_a: np.ndarray
    pair_b: np.ndarray
    npairs: np.ndarray
    max_pairs: int

    def to(self, device) -> "IPPlan":
        """The same plan with tensor fields on ``device`` (uploaded once)."""
        return IPPlan(_on(self.pair_a, device), _on(self.pair_b, device),
                      _on(self.npairs, device), self.max_pairs)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Flat (a_slot, b_slot, ci, cj) work list for OP/Gust dataflows.

    The *order* of the list is the loop order of the dataflow: k-major for OP
    (each k's rank-1 update contiguous), i-major for Gust (each output fiber's
    work contiguous).  ``seg_ptr`` delimits the outer-loop segments.
    """

    a_slot: np.ndarray
    b_slot: np.ndarray
    ci: np.ndarray
    cj: np.ndarray
    seg_ptr: np.ndarray   # (outer+1,) segment boundaries in the flat list
    order: str            # "k" (OP) or "i" (Gust)

    def to(self, device) -> "StreamPlan":
        """The same plan with tensor fields on ``device`` (uploaded once)."""
        return StreamPlan(_on(self.a_slot, device), _on(self.b_slot, device),
                          _on(self.ci, device), _on(self.cj, device),
                          self.seg_ptr, self.order)


def build_ip_plan(a: BlockCSR, b: BlockCSC) -> IPPlan:
    """Intersect every A row fiber with every B column fiber (paper: the
    scalar-vs-scalar intersection of IP, lifted to block coordinates)."""
    mb, kb = a.grid
    kb2, nb = b.grid
    assert kb == kb2, (a.grid, b.grid)
    a_indptr = np.asarray(a.indptr)
    a_indices = np.asarray(a.indices)
    b_indptr = np.asarray(b.indptr)
    b_indices = np.asarray(b.indices)

    pairs: list[list[tuple[np.ndarray, np.ndarray]]] = []
    max_pairs = 1
    for i in range(mb):
        arow_k = a_indices[a_indptr[i]: a_indptr[i + 1]]
        arow_slot = np.arange(a_indptr[i], a_indptr[i + 1])
        row = []
        for j in range(nb):
            bcol_k = b_indices[b_indptr[j]: b_indptr[j + 1]]
            bcol_slot = np.arange(b_indptr[j], b_indptr[j + 1])
            _, ia, ib = np.intersect1d(
                arow_k, bcol_k, assume_unique=True, return_indices=True
            )
            row.append((arow_slot[ia], bcol_slot[ib]))
            max_pairs = max(max_pairs, len(ia))
        pairs.append(row)

    pair_a = np.zeros((mb, nb, max_pairs), dtype=np.int32)
    pair_b = np.zeros((mb, nb, max_pairs), dtype=np.int32)
    npairs = np.zeros((mb, nb), dtype=np.int32)
    for i in range(mb):
        for j in range(nb):
            sa, sb = pairs[i][j]
            npairs[i, j] = len(sa)
            pair_a[i, j, : len(sa)] = sa
            pair_b[i, j, : len(sb)] = sb
    return IPPlan(pair_a, pair_b, npairs, max_pairs)


def _cat(xs) -> np.ndarray:
    return np.concatenate(xs).astype(np.int32) if xs else np.zeros(0, np.int32)


def build_op_plan(a: BlockCSC, b: BlockCSR) -> StreamPlan:
    """K-outermost cross products: for every k, pair each stationary A column
    element with each streamed B row element (rank-1 block update)."""
    mb, kb = a.grid
    kb2, nb = b.grid
    assert kb == kb2
    a_indptr = np.asarray(a.indptr)
    a_indices = np.asarray(a.indices)       # block-row coords of A col fibers
    b_indptr = np.asarray(b.indptr)
    b_indices = np.asarray(b.indices)       # block-col coords of B row fibers

    a_s, b_s, ci, cj, seg = [], [], [], [], [0]
    for k in range(kb):
        a_slots = np.arange(a_indptr[k], a_indptr[k + 1])
        a_rows = a_indices[a_indptr[k]: a_indptr[k + 1]]
        b_slots = np.arange(b_indptr[k], b_indptr[k + 1])
        b_cols = b_indices[b_indptr[k]: b_indptr[k + 1]]
        if len(a_slots) and len(b_slots):
            aa, bb = np.meshgrid(a_slots, b_slots, indexing="ij")
            rr, cc = np.meshgrid(a_rows, b_cols, indexing="ij")
            a_s.append(aa.ravel())
            b_s.append(bb.ravel())
            ci.append(rr.ravel())
            cj.append(cc.ravel())
        seg.append(seg[-1] + (len(a_slots) * len(b_slots)))
    return StreamPlan(_cat(a_s), _cat(b_s), _cat(ci), _cat(cj),
                      np.asarray(seg, np.int64), order="k")


def build_gust_plan(a: BlockCSR, b: BlockCSR) -> StreamPlan:
    """Row-major leader-follower: each A element (i,k) pulls B's whole row-k
    fiber; all work for output fiber *i* is contiguous."""
    mb, kb = a.grid
    kb2, nb = b.grid
    assert kb == kb2
    a_indptr = np.asarray(a.indptr)
    a_indices = np.asarray(a.indices)
    b_indptr = np.asarray(b.indptr)
    b_indices = np.asarray(b.indices)

    a_s, b_s, ci, cj, seg = [], [], [], [], [0]
    count = 0
    for i in range(mb):
        for a_slot in range(a_indptr[i], a_indptr[i + 1]):
            k = a_indices[a_slot]
            lo, hi = b_indptr[k], b_indptr[k + 1]
            n = hi - lo
            if n:
                a_s.append(np.full(n, a_slot, np.int32))
                b_s.append(np.arange(lo, hi, dtype=np.int32))
                ci.append(np.full(n, i, np.int32))
                cj.append(b_indices[lo:hi].astype(np.int32))
                count += int(n)
        seg.append(count)
    return StreamPlan(_cat(a_s), _cat(b_s), _cat(ci), _cat(cj),
                      np.asarray(seg, np.int64), order="i")


# ---------------------------------------------------------------------------
# Torch reference executions
# ---------------------------------------------------------------------------


def ip_m(a: BlockCSR, b: BlockCSC, plan: IPPlan | None = None
         ) -> torch.Tensor:
    """Inner Product, M-stationary (MNK).  No partial sums leave the C block."""
    if plan is None:
        plan = build_ip_plan(a, b)  # lint: host-ok (concrete-only fallback)
    dev = a.data.device
    if a.nnzb == 0 or b.nnzb == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                           device=dev)
    mb, nb = a.grid[0], b.grid[1]
    bm, bn = a.block_shape[0], b.block_shape[1]
    pair_a = _on(plan.pair_a, dev)
    pair_b = _on(plan.pair_b, dev)
    npairs = _on(plan.npairs, dev)
    ablk = a.data.float()[pair_a]                        # (Mb, Nb, P, bm, bk)
    bblk = b.data.float()[pair_b]                        # (Mb, Nb, P, bk, bn)
    p = pair_a.shape[-1]
    mask = torch.arange(p, device=dev) < npairs[..., None]
    ablk = torch.where(mask[..., None, None], ablk, 0.0)
    # full-sum reduce over the intersected K fiber (FAN-reduce analogue)
    c = torch.einsum("mnpij,mnpjk->mnik", ablk, bblk)    # (Mb, Nb, bm, bn)
    c = c.transpose(1, 2).reshape(mb * bm, nb * bn)
    return c[: a.shape[0], : b.shape[1]]


def _stream_execute(a_data, b_data, plan: StreamPlan, out_grid, blocks, m, n):
    """Shared OP/Gust executor: flat block-GEMM work list + coordinate-indexed
    psum accumulation (the PSRAM/merge analogue) on a flattened block index.

    Entries whose block coordinates lie outside the grid are dropped, as
    JAX's scatter drops them: the pad entries of a tiled plan's padded
    slabs aim one row past the grid.  They add into one spare block that is
    cut away, so nothing is filtered on the host."""
    mb, nb = out_grid
    bm, bn = blocks
    dev = a_data.device
    if len(plan.a_slot) == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    a_blk = a_data.float()[_on(plan.a_slot, dev)]        # (W, bm, bk)
    b_blk = b_data.float()[_on(plan.b_slot, dev)]        # (W, bk, bn)
    psums = torch.bmm(a_blk, b_blk)                      # (W, bm, bn)
    ci, cj = _on(plan.ci, dev).long(), _on(plan.cj, dev).long()
    inside = (ci >= 0) & (ci < mb) & (cj >= 0) & (cj < nb)
    flat = torch.where(inside, ci * nb + cj, mb * nb)
    c = torch.zeros((mb * nb + 1, bm, bn), dtype=psums.dtype, device=dev)
    c.index_add_(0, flat, psums)
    c = c[:-1].reshape(mb, nb, bm, bn).transpose(1, 2).reshape(mb * bm,
                                                              nb * bn)
    return c[:m, :n]


def op_m(a: BlockCSC, b: BlockCSR, plan: StreamPlan | None = None
         ) -> torch.Tensor:
    """Outer Product, M-stationary (KMN).  Every k streams a rank-1 update."""
    if plan is None:
        plan = build_op_plan(a, b)  # lint: host-ok (concrete-only fallback)
    return _stream_execute(a.data, b.data, plan, (a.grid[0], b.grid[1]),
                           (a.block_shape[0], b.block_shape[1]),
                           a.shape[0], b.shape[1])


def gust_m(a: BlockCSR, b: BlockCSR, plan: StreamPlan | None = None
           ) -> torch.Tensor:
    """Gustavson, M-stationary (MKN).  Leader-follower row gather."""
    if plan is None:
        plan = build_gust_plan(a, b)  # lint: host-ok (concrete-only fallback)
    return _stream_execute(a.data, b.data, plan, (a.grid[0], b.grid[1]),
                           (a.block_shape[0], b.block_shape[1]),
                           a.shape[0], b.shape[1])


# --- N-stationary variants via the transpose duality:  C = (Bᵀ Aᵀ)ᵀ --------
#
# A BlockCSC of X carries exactly the fibers of Xᵀ in BlockCSR layout (same
# data blocks, transposed within-block), so the N variants reuse the M
# executors on swapped, transposed operands.  The block transposes are
# views; consumers that need contiguous stacks (the CUDA kernels) copy.


def _transpose_bcsr_of(x: BlockCSC) -> BlockCSR:
    return BlockCSR(
        x.data.transpose(1, 2), x.indptr, x.indices,
        (x.shape[1], x.shape[0]), (x.block_shape[1], x.block_shape[0]),
    )


def _transpose_bcsc_of(x: BlockCSR) -> BlockCSC:
    return BlockCSC(
        x.data.transpose(1, 2), x.indptr, x.indices,
        (x.shape[1], x.shape[0]), (x.block_shape[1], x.block_shape[0]),
    )


def ip_n(a: BlockCSR, b: BlockCSC, plan: IPPlan | None = None
         ) -> torch.Tensor:
    """Inner Product, N-stationary (NMK): IP over (Bᵀ, Aᵀ), transposed."""
    return ip_m(_transpose_bcsr_of(b), _transpose_bcsc_of(a), plan).T


def op_n(a: BlockCSC, b: BlockCSR, plan: StreamPlan | None = None
         ) -> torch.Tensor:
    """Outer Product, N-stationary (KNM)."""
    return op_m(_transpose_bcsc_of(b), _transpose_bcsr_of(a), plan).T


def gust_n(a: BlockCSC, b: BlockCSC, plan: StreamPlan | None = None
           ) -> torch.Tensor:
    """Gustavson, N-stationary (NKM): B's fibers lead, A follows."""
    return gust_m(_transpose_bcsr_of(b), _transpose_bcsr_of(a), plan).T


# ---------------------------------------------------------------------------
# Convenience driver matching Table 3's format requirements
# ---------------------------------------------------------------------------


def run_dataflow(name: str, a_dense, b_dense,
                 block_shape: Tuple[int, ...] = (8, 8), *,
                 device=None) -> torch.Tensor:
    """Compress operands per Table 3 for ``name`` and execute it.

    ``block_shape`` is ``(bm, bk, bn)``; the legacy 2-tuple ``(bm, bk)`` is
    accepted with ``bn = bk``.  ``device=None`` keeps a tensor operand's
    device and otherwise resolves to the card.
    """
    if len(block_shape) == 2:
        bm, bk = block_shape
        bn = bk
    else:
        bm, bk, bn = block_shape
    bs, bs_b = (bm, bk), (bk, bn)
    kw = {"device": device}
    if name == "ip_m":
        return ip_m(dense_to_bcsr(a_dense, bs, **kw),
                    dense_to_bcsc(b_dense, bs_b, **kw))
    if name == "op_m":
        return op_m(dense_to_bcsc(a_dense, bs, **kw),
                    dense_to_bcsr(b_dense, bs_b, **kw))
    if name == "gust_m":
        return gust_m(dense_to_bcsr(a_dense, bs, **kw),
                      dense_to_bcsr(b_dense, bs_b, **kw))
    if name == "ip_n":
        return ip_n(dense_to_bcsr(a_dense, bs, **kw),
                    dense_to_bcsc(b_dense, bs_b, **kw))
    if name == "op_n":
        return op_n(dense_to_bcsc(a_dense, bs, **kw),
                    dense_to_bcsr(b_dense, bs_b, **kw))
    if name == "gust_n":
        return gust_n(dense_to_bcsc(a_dense, bs, **kw),
                      dense_to_bcsc(b_dense, bs_b, **kw))
    raise ValueError(f"unknown dataflow {name!r}; expected one of {DATAFLOWS}")
