"""Sparse matrix formats.

Two families live here:

1. **Block formats** (``BlockCSR``, ``BlockCSC``) — values are stored as
   dense ``(bm, bk)`` blocks in a torch tensor on the operand's device; the
   coordinate structure (indptr/indices) is kept at *block* granularity in
   host numpy arrays, because it is phase-1 data: plan builders read it,
   kernels never do.  A block is "present" iff it contains at least one
   nonzero scalar.  These feed the torch dataflow references
   (:mod:`repro_torch.core.dataflows`) and the CUDA kernels
   (:mod:`repro_torch.kernels`).

2. **Scalar formats** (``CSR``, ``CSC``) — numpy-level, element granularity.
   These model the paper's fibers exactly — each fiber is a coordinate-sorted
   list of (coordinate, value) duples.

Terminology follows the paper (§2.1): a *fiber* is one compressed row (CSR) or
column (CSC); an *element* is one (coordinate, value) duple.

Every array this module builds on the host is byte-equal to what
``repro.core.formats`` builds from the same input.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple, Union

import numpy as np
import torch

from ..config import resolve_device

__all__ = [
    "SparseFormat",
    "BlockCSR",
    "BlockCSC",
    "CSR",
    "CSC",
    "block_partition",
    "dense_to_bcsr",
    "dense_to_bcsc",
    "random_block_sparse",
    "random_sparse_dense",
    "block_occupancy",
    "blockize",
    "to_host",
    "target_device",
]


class SparseFormat(enum.Enum):
    """The four storage formats behind one constructor surface.

    Block formats feed the dataflow executors / CUDA kernels; scalar
    formats are the paper-exact fibers.
    """

    BCSR = "bcsr"
    BCSC = "bcsc"
    CSR = "csr"
    CSC = "csc"

    @classmethod
    def of(cls, fmt: Union[str, "SparseFormat"]) -> "SparseFormat":
        return fmt if isinstance(fmt, cls) else cls(str(fmt).lower())

    @property
    def is_block(self) -> bool:
        return self in (SparseFormat.BCSR, SparseFormat.BCSC)

    @property
    def major(self) -> str:
        """Fiber major order: rows ("csr") or columns ("csc")."""
        return "csr" if self in (SparseFormat.BCSR, SparseFormat.CSR) \
            else "csc"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def blockize(x: torch.Tensor, block_shape) -> torch.Tensor:
    """(M, K) -> (Mb, Kb, bm, bk) view of its blocks, zero-padded to whole
    blocks (a copy only where it is padded)."""
    m, k = x.shape
    bm, bk = block_shape
    pm, pk = _ceil_div(m, bm) * bm, _ceil_div(k, bk) * bk
    if (pm, pk) != (m, k):
        x = torch.nn.functional.pad(x, (0, pk - k, 0, pm - m))
    return x.reshape(pm // bm, bm, pk // bk, bk).transpose(1, 2)


def to_host(x) -> np.ndarray:
    """A numpy view of ``x`` (a torch tensor on any device, or array-like).

    numpy has no bf16: a bf16 tensor comes to the host as fp32, which holds
    each of its values exactly."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def target_device(x, device) -> torch.device:
    """Where values built from ``x`` live: an explicit ``device`` wins, a
    torch tensor keeps its own, anything else resolves ``None`` (the card)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _pad_to_blocks(x: np.ndarray, block_shape) -> np.ndarray:
    """Zero-pad a 2-D array so both dims are multiples of ``block_shape``."""
    m, k = x.shape
    bm, bk = block_shape
    pm, pk = _ceil_div(m, bm) * bm, _ceil_div(k, bk) * bk
    if (pm, pk) == (m, k):
        return x
    out = np.zeros((pm, pk), dtype=x.dtype)
    out[:m, :k] = x
    return out


def block_partition(x, block_shape) -> np.ndarray:
    """Reshape a (padded) dense matrix to (Mb, Kb, bm, bk) block layout."""
    x = _pad_to_blocks(to_host(x), block_shape)
    m, k = x.shape
    bm, bk = block_shape
    return x.reshape(m // bm, bm, k // bk, bk).swapaxes(1, 2)


def block_occupancy(x, block_shape) -> np.ndarray:
    """Boolean (Mb, Kb) bitmap: block present iff any scalar nonzero."""
    blocks = block_partition(x, block_shape)
    return np.asarray((np.abs(blocks) > 0).any(axis=(2, 3)))


def _scatter_blocks(data: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
                    grid: Tuple[int, int], block_shape, shape) -> torch.Tensor:
    mb, kb = grid
    bm, bk = block_shape
    out = torch.zeros((mb, kb, bm, bk), dtype=data.dtype, device=data.device)
    dev = data.device
    out[torch.as_tensor(rows, device=dev).long(),
        torch.as_tensor(cols, device=dev).long()] = data
    out = out.transpose(1, 2).reshape(mb * bm, kb * bk)
    return out[: shape[0], : shape[1]]


@dataclasses.dataclass
class BlockCSR:
    """Block compressed sparse row.  Fibers = block rows, sorted by block col.

    data:    (nnzb, bm, bk) dense value blocks, row-major fiber order.
    indptr:  (Mb + 1,) int32 numpy — fiber start offsets into ``data``.
    indices: (nnzb,) int32 numpy — block-column coordinate of each element.
    """

    data: torch.Tensor
    indptr: np.ndarray
    indices: np.ndarray
    shape: Tuple[int, int]          # logical (unpadded) dense shape
    block_shape: Tuple[int, int]

    @property
    def nnzb(self) -> int:
        return int(self.data.shape[0])

    @property
    def grid(self) -> Tuple[int, int]:
        bm, bk = self.block_shape
        return _ceil_div(self.shape[0], bm), _ceil_div(self.shape[1], bk)

    @property
    def density(self) -> float:
        mb, kb = self.grid
        return self.nnzb / max(1, mb * kb)

    def todense(self) -> torch.Tensor:
        mb, _ = self.grid
        rows = np.repeat(np.arange(mb), np.diff(self.indptr))
        return _scatter_blocks(self.data, rows, self.indices, self.grid,
                               self.block_shape, self.shape)

    def bitmap(self) -> np.ndarray:
        mb, kb = self.grid
        bit = np.zeros((mb, kb), dtype=bool)
        rows = np.repeat(np.arange(mb), np.diff(self.indptr))
        bit[rows, self.indices] = True
        return bit


@dataclasses.dataclass
class BlockCSC:
    """Block compressed sparse column.  Fibers = block cols, sorted by row.

    data:    (nnzb, bm, bk) dense value blocks, column-major fiber order.
    indptr:  (Kb + 1,) int32 numpy — fiber start offsets.
    indices: (nnzb,) int32 numpy — block-row coordinate of each element.
    """

    data: torch.Tensor
    indptr: np.ndarray
    indices: np.ndarray
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nnzb(self) -> int:
        return int(self.data.shape[0])

    @property
    def grid(self) -> Tuple[int, int]:
        bm, bk = self.block_shape
        return _ceil_div(self.shape[0], bm), _ceil_div(self.shape[1], bk)

    @property
    def density(self) -> float:
        mb, kb = self.grid
        return self.nnzb / max(1, mb * kb)

    def todense(self) -> torch.Tensor:
        _, kb = self.grid
        cols = np.repeat(np.arange(kb), np.diff(self.indptr))
        return _scatter_blocks(self.data, self.indices, cols, self.grid,
                               self.block_shape, self.shape)

    def bitmap(self) -> np.ndarray:
        mb, kb = self.grid
        bit = np.zeros((mb, kb), dtype=bool)
        cols = np.repeat(np.arange(kb), np.diff(self.indptr))
        bit[self.indices, cols] = True
        return bit


def dense_to_bcsr(x, block_shape, *, device=None) -> BlockCSR:
    """Compress a dense matrix to BlockCSR (host-side, concrete values)."""
    dev = target_device(x, device)
    dtype = x.dtype if isinstance(x, torch.Tensor) else None
    x = to_host(x)
    shape = x.shape
    blocks = block_partition(x, block_shape)          # (Mb, Kb, bm, bk)
    occ = (np.abs(blocks) > 0).any(axis=(2, 3))       # (Mb, Kb)
    rows, cols = np.nonzero(occ)                      # row-major order
    data = blocks[rows, cols]
    indptr = np.zeros(occ.shape[0] + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=occ.shape[0]), out=indptr[1:])
    return BlockCSR(torch.as_tensor(data, device=dev, dtype=dtype), indptr,
                    cols.astype(np.int32), shape, tuple(block_shape))


def dense_to_bcsc(x, block_shape, *, device=None) -> BlockCSC:
    """Compress a dense matrix to BlockCSC (host-side, concrete values)."""
    dev = target_device(x, device)
    dtype = x.dtype if isinstance(x, torch.Tensor) else None
    x = to_host(x)
    shape = x.shape
    blocks = block_partition(x, block_shape)
    occ = (np.abs(blocks) > 0).any(axis=(2, 3))
    cols, rows = np.nonzero(occ.T)                    # column-major order
    data = blocks[rows, cols]
    indptr = np.zeros(occ.shape[1] + 1, dtype=np.int32)
    np.cumsum(np.bincount(cols, minlength=occ.shape[1]), out=indptr[1:])
    return BlockCSC(torch.as_tensor(data, device=dev, dtype=dtype), indptr,
                    rows.astype(np.int32), shape, tuple(block_shape))


def random_sparse_dense(
    rng: np.random.Generator,
    shape: Tuple[int, int],
    *,
    density: float,
    block_shape: Tuple[int, int] | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Random dense matrix with target sparsity.

    If ``block_shape`` is given, sparsity is *block structured* (whole blocks
    zeroed).  Otherwise unstructured element sparsity (the paper's regime;
    blocks then have partial occupancy).  Same draws as the JAX package's
    function for the same generator state.
    """
    x = rng.standard_normal(shape).astype(dtype)
    if block_shape is None:
        mask = rng.random(shape) < density
        return np.where(mask, x, 0.0).astype(dtype)
    bm, bk = block_shape
    gm, gk = _ceil_div(shape[0], bm), _ceil_div(shape[1], bk)
    bmask = rng.random((gm, gk)) < density
    mask = np.kron(bmask, np.ones((bm, bk), dtype=bool))[: shape[0], : shape[1]]
    return np.where(mask, x, 0.0).astype(dtype)


def random_block_sparse(
    rng: np.random.Generator,
    shape: Tuple[int, int],
    *,
    density: float,
    block_shape: Tuple[int, int],
    fmt: str = "bcsr",
    dtype=np.float32,
    device=None,
):
    x = random_sparse_dense(
        rng, shape, density=density, block_shape=block_shape, dtype=dtype
    )
    if fmt == "bcsr":
        return dense_to_bcsr(x, block_shape, device=device)
    if fmt == "bcsc":
        return dense_to_bcsc(x, block_shape, device=device)
    raise ValueError(f"unknown fmt {fmt!r}")


# ---------------------------------------------------------------------------
# Scalar CSR / CSC — element granularity, numpy.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSR:
    """Paper-exact CSR: data vector, row pointer vector, column index vector."""

    data: np.ndarray      # (nnz,)
    indptr: np.ndarray    # (M + 1,)
    indices: np.ndarray   # (nnz,) column coordinate of each element
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def fiber(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (coords, values) of fiber *i* (row *i*), coordinate-sorted."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def fiber_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def nbytes(self, word_bytes: int = 4) -> int:
        """Compressed footprint: each element is a (coord, value) word pair."""
        return self.nnz * word_bytes + self.indptr.size * 4

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    @staticmethod
    def from_dense(x) -> "CSR":
        x = to_host(x)
        rows, cols = np.nonzero(x)
        indptr = np.zeros(x.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=x.shape[0]), out=indptr[1:])
        return CSR(x[rows, cols], indptr, cols.astype(np.int64), x.shape)


@dataclasses.dataclass
class CSC:
    """Paper-exact CSC: data vector, column pointer vector, row index vector."""

    data: np.ndarray
    indptr: np.ndarray    # (N + 1,)
    indices: np.ndarray   # (nnz,) row coordinate of each element
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def fiber(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[j], self.indptr[j + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def fiber_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def nbytes(self, word_bytes: int = 4) -> int:
        return self.nnz * word_bytes + self.indptr.size * 4

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        cols = np.repeat(np.arange(self.shape[1]), np.diff(self.indptr))
        out[self.indices, cols] = self.data
        return out

    @staticmethod
    def from_dense(x) -> "CSC":
        x = to_host(x)
        cols, rows = np.nonzero(x.T)
        indptr = np.zeros(x.shape[1] + 1, dtype=np.int64)
        np.cumsum(np.bincount(cols, minlength=x.shape[1]), out=indptr[1:])
        return CSC(x[rows, cols], indptr, rows.astype(np.int64), x.shape)
