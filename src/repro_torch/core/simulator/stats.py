"""Layer statistics consumed by the accelerator models.

A :class:`LayerStats` captures everything the cycle models need about one
SpMSpM operation: exact per-fiber nonzero counts of A and B, the effectual
multiply count, and the output nonzero count.  Stats are computed from
concrete sparsity *patterns* (boolean masks) so fiber distributions are exact;
values are irrelevant to timing.

``from_layer`` generates a deterministic random pattern with the target
sparsity (the paper's models are unstructured-sparse; Table 2/6 give only
ratios, so patterns are sampled).  Byte-equal to the JAX package's
``repro.core.simulator.stats`` on the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["LayerSpec", "LayerStats", "from_masks", "from_layer"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One GEMM layer: C[M,N] = A[M,K] @ B[K,N] with sparsity in percent."""

    name: str
    m: int
    n: int
    k: int
    sp_a: float          # % zeros in A (paper convention)
    sp_b: float
    model: str = ""

    @property
    def density_a(self) -> float:
        return max(0.0, 1.0 - self.sp_a / 100.0)

    @property
    def density_b(self) -> float:
        return max(0.0, 1.0 - self.sp_b / 100.0)


@dataclasses.dataclass
class LayerStats:
    spec: LayerSpec
    nnz_a: int
    nnz_b: int
    nnz_c: int
    a_row_nnz: np.ndarray     # (M,) elements per A row fiber
    a_col_nnz: np.ndarray     # (K,) elements per A column fiber
    b_row_nnz: np.ndarray     # (K,) elements per B row fiber
    b_col_nnz: np.ndarray     # (N,)
    mults: int                # effectual scalar multiplies (dataflow-invariant)
    row_psums: np.ndarray     # (M,) psums produced for output row m (OP/Gust)

    def cs_bytes(self, which: str, word_bytes: int = 4) -> int:
        """Compressed size: (coord,value) word per element + pointer vector."""
        if which == "a":
            return self.nnz_a * word_bytes + 4 * (self.spec.m + 1)
        if which == "b":
            return self.nnz_b * word_bytes + 4 * (self.spec.k + 1)
        if which == "c":
            return self.nnz_c * word_bytes + 4 * (self.spec.m + 1)
        raise ValueError(which)


def from_masks(spec: LayerSpec, a_mask: np.ndarray, b_mask: np.ndarray
               ) -> LayerStats:
    a_row = a_mask.sum(1).astype(np.int64)
    a_col = a_mask.sum(0).astype(np.int64)
    b_row = b_mask.sum(1).astype(np.int64)
    b_col = b_mask.sum(0).astype(np.int64)
    mults = int(a_col @ b_row)
    # exact output pattern via boolean matmul (float for speed)
    c_nnz = int(
        ((a_mask.astype(np.float32) @ b_mask.astype(np.float32)) > 0).sum()
    )
    return LayerStats(
        spec=spec,
        nnz_a=int(a_mask.sum()),
        nnz_b=int(b_mask.sum()),
        nnz_c=c_nnz,
        a_row_nnz=a_row,
        a_col_nnz=a_col,
        b_row_nnz=b_row,
        b_col_nnz=b_col,
        mults=mults,
        row_psums=(a_mask.astype(np.int64) @ b_row).astype(np.int64),
    )


_MAX_EXACT_ELEMENTS = 64 << 20   # above this, use the analytic path


def from_layer(spec: LayerSpec, seed: int = 0) -> LayerStats:
    """Deterministic stats for a layer spec.

    Exact mask-based stats when the matrices are modest; analytic
    (uniform-pattern expectation) for very large layers, where the law of
    large numbers makes the expectation tight.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, spec.m, spec.n, spec.k,
                                int(spec.sp_a * 100), int(spec.sp_b * 100)])
    )
    if spec.m * spec.k + spec.k * spec.n <= _MAX_EXACT_ELEMENTS:
        a_mask = rng.random((spec.m, spec.k)) < spec.density_a
        b_mask = rng.random((spec.k, spec.n)) < spec.density_b
        return from_masks(spec, a_mask, b_mask)

    da, db = spec.density_a, spec.density_b
    nnz_a = int(round(spec.m * spec.k * da))
    nnz_b = int(round(spec.k * spec.n * db))
    p_c = 1.0 - (1.0 - da * db) ** spec.k
    return LayerStats(
        spec=spec,
        nnz_a=nnz_a,
        nnz_b=nnz_b,
        nnz_c=int(round(spec.m * spec.n * p_c)),
        a_row_nnz=np.full(spec.m, max(0, round(spec.k * da)), np.int64),
        a_col_nnz=np.full(spec.k, max(0, round(spec.m * da)), np.int64),
        b_row_nnz=np.full(spec.k, max(0, round(spec.n * db)), np.int64),
        b_col_nnz=np.full(spec.n, max(0, round(spec.k * db)), np.int64),
        mults=int(round(spec.m * da * spec.k * spec.n * db)),
        row_psums=np.full(
            spec.m, max(0, round(da * spec.k * spec.n * db)), np.int64),
    )
