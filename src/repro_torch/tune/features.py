"""Cheap pattern features for learned dataflow selection (Misam-style).

A copy of ``repro.tune.features`` (numpy only): the same vector, byte for
byte, for the same context.

The premise (arXiv 2406.10166, and the whole Flexagon paper): the best
SpMSpM dataflow is a function of the operation's *pattern* — dimensions,
sparsity degrees, where the nonzero blocks sit — and that function is
learnable from features far cheaper than pricing every candidate with the
cycle-level simulator.  This module is the feature side of that bargain:
one fixed-length vector per :class:`repro_torch.backends.SelectionContext`,
computed from the block-occupancy bitmaps with a handful of vectorized
numpy passes (microseconds, never values, never a simulator call).

Every feature is scale-normalized (log dims, occupancy fractions, grid-
relative band distances) so one model generalizes across shapes.  The
vector layout is frozen by :data:`FEATURE_NAMES`; serialized models carry
it and refuse to load against a different layout (see
:meth:`repro_torch.tune.learned.LearnedPolicy.load`).

The strongest features are the **analytic proxy costs**: a closed-form
expected-value transliteration of the cycle models in
:mod:`repro_torch.core.simulator.accelerators` — the same fill/stream/merge
phase maxima and DRAM bound, evaluated on the uniform-pattern
expectations of the fiber statistics instead of a sampled pattern (the
``from_layer`` analytic path).  Six scalar costs in ~40 µs of pure
python; the model then only has to learn where a real pattern's sampled
statistics deviate from expectation.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..core.simulator.config import PAPER_CONFIG

__all__ = ["FEATURE_NAMES", "N_FEATURES", "proxy_costs", "pattern_features",
           "context_features"]

#: Per-fiber occupancy histogram bin edges (fractions of a full fiber).
_HIST_EDGES = (0.25, 0.5, 0.75)

FEATURE_NAMES: Tuple[str, ...] = (
    # dimensions (log2 so one model spans 64 .. 64k)
    "log_m", "log_k", "log_n", "log_bm", "log_bk", "log_bn",
    "log_m_over_n", "log_m_over_k", "log_k_over_n",
    # densities
    "density_a", "density_b", "density_c_expected",
    # A block-occupancy structure: per-row / per-col occupancy stats
    "a_row_mean", "a_row_std", "a_row_max", "a_row_min",
    "a_col_mean", "a_col_std", "a_col_max",
    # B block-occupancy structure
    "b_row_mean", "b_row_std", "b_row_max",
    "b_col_mean", "b_col_std", "b_col_max", "b_col_min",
    # occupancy histograms (fraction of fibers per occupancy quartile)
    "a_row_hist0", "a_row_hist1", "a_row_hist2", "a_row_hist3",
    "b_col_hist0", "b_col_hist1", "b_col_hist2", "b_col_hist3",
    # band / diagonal structure
    "a_band_dist", "a_diag_frac", "b_band_dist", "b_diag_frac",
    # memory-budget context
    "has_budget", "log_l1", "log_l2", "log_footprint_ratio",
    # placement context
    "log_shards",
    # analytic proxy costs (expected-value cycle models, see module doc):
    # log1p relative slack of each candidate over the proxy's own argmin
    "proxy_slack_ip_m", "proxy_slack_op_m", "proxy_slack_gust_m",
    "proxy_slack_ip_n", "proxy_slack_op_n", "proxy_slack_gust_n",
    "proxy_log_min_cycles",
)

N_FEATURES = len(FEATURE_NAMES)

# PAPER_CONFIG substrate constants, hoisted once (the proxy runs on the
# serving path; attribute lookups per call would double its cost).
_W = PAPER_CONFIG.word_bytes
_DN = PAPER_CONFIG.dn_bandwidth
_RN = PAPER_CONFIG.rn_bandwidth
_MULS = PAPER_CONFIG.num_multipliers
_LINE = PAPER_CONFIG.str_line_bytes
_CACHE = PAPER_CONFIG.str_cache_bytes
_PSRAM = PAPER_CONFIG.psram_bytes
_DRAM_BPC = PAPER_CONFIG.dram_bytes_per_cycle
_DRAM_LAT = PAPER_CONFIG.dram_latency_cycles
_MLP = PAPER_CONFIG.gather_mlp


def _merge_passes(n_fibers: float, leaves: int) -> int:
    # mirrors accelerators._merge_passes
    if n_fibers <= 1:
        return 0
    return max(1, math.ceil(math.log(max(2.0, n_fibers), leaves)))


def _proxy_m(m: float, k: float, n: float, da: float, db: float
             ) -> Tuple[float, float, float]:
    """Expected cycles for (ip_m, op_m, gust_m) on an m×k×n layer.

    Uniform-expectation fiber stats: every A row holds k·da elements, so
    ``_pack_rounds`` (which splits fibers) degenerates to ceil(nnz_a/muls)
    and the per-row merge-pass loops to a single closed form.
    """
    nnz_a = m * k * da
    nnz_b = k * n * db
    mults = m * k * n * da * db
    p = da * db
    nnz_c = 0.0 if p <= 0 else m * n * (1.0 - (1.0 - min(p, 1.0)) ** k)
    cs_a = nnz_a * _W + 4 * (m + 1)
    cs_b = nnz_b * _W + 4 * (k + 1)
    cs_c = nnz_c * _W + 4 * (m + 1)
    lines_b = math.ceil(nnz_b * _W / _LINE)
    fill = nnz_a / _DN

    # ip: stationary A rows, B swept once per packing round
    rounds = max(1, math.ceil(nnz_a / _MULS))
    stream = max(rounds * nnz_b / _DN, mults / _MULS, nnz_c / _RN)
    misses = float(lines_b) if cs_b <= _CACHE else float(rounds) * lines_b
    off = cs_a + misses * _LINE + cs_c
    ip = max(fill + stream, off / _DRAM_BPC + _DRAM_LAT)

    # op: B injected once, every psum through PSRAM, multi-pass merge
    passes = _merge_passes(k * da, _MULS)
    stream = max(nnz_b / _DN, mults / _MULS, mults / _RN)
    merge = mults * passes / _RN
    spill = max(0.0, mults * _W - _PSRAM)
    off = cs_a + lines_b * _LINE + cs_c + 2.0 * spill
    op = max(fill + stream + merge, off / _DRAM_BPC + _DRAM_LAT)

    # gust: leader-follower B fetches, merge overlapped unless rows > leaves
    stream = max(mults / _DN, mults / _MULS)
    extra = mults * (passes - 1) if passes > 1 else 0.0
    psram = 2.0 * _W * mults if passes > 1 else 0.0
    merge = extra / _RN
    if cs_b <= _CACHE:
        misses = float(lines_b)
    else:
        refetch = k * (m * da) * math.ceil(n * db * _W / _LINE)
        beta = min(1.0, max(0.0, (cs_b - _CACHE) / cs_b))
        misses = lines_b + beta * max(0.0, refetch - lines_b)
    stalls = misses * _DRAM_LAT / _MLP
    spill = max(0.0, psram / 2.0 - _PSRAM)
    off = cs_a + misses * _LINE + cs_c + 2.0 * spill
    gust = max(fill + stream + merge + stalls, off / _DRAM_BPC + _DRAM_LAT)
    return ip, op, gust


def proxy_costs(m: int, k: int, n: int, da: float, db: float) -> dict:
    """Expected cycles per dataflow (N variants price the transposed dual,
    exactly like :meth:`repro_torch.backends.simulator.SimulatorBackend.cost`)."""
    ip_m, op_m, gust_m = _proxy_m(m, k, n, da, db)
    ip_n, op_n, gust_n = _proxy_m(n, k, m, db, da)
    return {"ip_m": ip_m, "op_m": op_m, "gust_m": gust_m,
            "ip_n": ip_n, "op_n": op_n, "gust_n": gust_n}


def _log2(x: float) -> float:
    return math.log2(max(float(x), 1e-12))


def _fiber_stats(frac: np.ndarray, with_min: bool = False) -> list:
    """mean/std/max(/min) of a per-fiber occupancy-fraction vector.

    Direct ``sum``/``dot`` reductions instead of ``.mean()``/``.std()``:
    the numpy method dispatch costs ~10–30 µs per call on these tiny
    vectors, and four calls per feature vector put that on the serving
    path.
    """
    n = frac.size
    if n == 0:
        return [0.0, 0.0, 0.0] + ([0.0] if with_min else [])
    s = float(frac.sum())
    mean = s / n
    var = float(frac.dot(frac)) / n - mean * mean
    out = [mean, math.sqrt(max(var, 0.0)), float(frac.max())]
    if with_min:
        out.append(float(frac.min()))
    return out


def _fiber_hist(frac: np.ndarray) -> list:
    """4-bin histogram of per-fiber occupancy fractions (sums to 1)."""
    n = frac.size
    if n == 0:
        return [0.0, 0.0, 0.0, 0.0]
    e0, e1, e2 = _HIST_EDGES
    c0 = np.count_nonzero(frac < e0)
    c1 = np.count_nonzero(frac < e1)
    c2 = np.count_nonzero(frac < e2)
    return [c0 / n, (c1 - c0) / n, (c2 - c1) / n, (n - c2) / n]


def _band_stats(occ: np.ndarray) -> Tuple[float, float]:
    """(mean grid-relative |row - col| distance, diagonal-band fraction).

    Distances are normalized by the grid extents so a band matrix scores
    the same at any size; ``diag_frac`` is the share of occupied blocks
    within 1/8 of the (relative) diagonal — 1.0 for block-diagonal,
    ≈ 0.23 for uniform occupancy.
    """
    idx = np.flatnonzero(occ)
    if idx.size == 0:
        return 0.0, 0.0
    ncols = occ.shape[1]
    d = np.abs((idx // ncols) * (1.0 / max(occ.shape[0] - 1, 1))
               - (idx % ncols) * (1.0 / max(ncols - 1, 1)))
    return (float(d.sum()) / d.size,
            np.count_nonzero(d < 0.125) / d.size)


def pattern_features(shape, block_shape: Tuple[int, int, int],
                     occ_a: np.ndarray, occ_b: np.ndarray,
                     memory_budget: Optional[object] = None,
                     n_shards: int = 1) -> np.ndarray:
    """One :data:`FEATURE_NAMES`-ordered vector for a (pattern, context).

    ``shape`` is a :class:`repro_torch.core.selector.LayerShape` (dims +
    densities); ``occ_a``/``occ_b`` the block-occupancy bitmaps.  All
    numpy, no simulator, no values — cheap enough for the per-request
    serving path.
    """
    bm, bk, bn = block_shape
    da, db = float(shape.density_a), float(shape.density_b)
    kb = max(occ_a.shape[1], 1)
    # P(C block nonzero) = 1 - (1 - da*db)^Kb under independence
    p = da * db
    dc = 0.0 if p <= 0 else 1.0 - (1.0 - min(p, 1.0)) ** kb

    zero = np.zeros(0)
    a_rows = occ_a.sum(axis=1) * (1.0 / occ_a.shape[1]) if occ_a.size else zero
    a_cols = occ_a.sum(axis=0) * (1.0 / occ_a.shape[0]) if occ_a.size else zero
    b_rows = occ_b.sum(axis=1) * (1.0 / occ_b.shape[1]) if occ_b.size else zero
    b_cols = occ_b.sum(axis=0) * (1.0 / occ_b.shape[0]) if occ_b.size else zero
    a_band, a_diag = _band_stats(occ_a)
    b_band, b_diag = _band_stats(occ_b)

    if memory_budget is not None:
        blk_bytes = float(memory_budget.dtype_bytes)
        footprint = (float(a_rows.sum()) * occ_a.shape[1] * bm * bk
                     + float(b_rows.sum()) * occ_b.shape[1] * bk * bn
                     + float(occ_a.shape[0] * occ_b.shape[1]) * bm * bn
                     ) * blk_bytes
        onchip = float(memory_budget.l1_bytes + memory_budget.l2_bytes)
        budget_feats = [1.0, _log2(memory_budget.l1_bytes),
                        _log2(memory_budget.l2_bytes),
                        max(-8.0, min(8.0, _log2(footprint / onchip)))]
    else:
        budget_feats = [0.0, 0.0, 0.0, 0.0]

    pc = proxy_costs(shape.m, shape.k, shape.n, da, db)
    pmin = max(min(pc.values()), 1e-9)

    feats = [
        _log2(shape.m), _log2(shape.k), _log2(shape.n),
        _log2(bm), _log2(bk), _log2(bn),
        _log2(shape.m) - _log2(shape.n),
        _log2(shape.m) - _log2(shape.k),
        _log2(shape.k) - _log2(shape.n),
        da, db, dc,
        *_fiber_stats(a_rows, with_min=True),
        *_fiber_stats(a_cols),
        *_fiber_stats(b_rows),
        *_fiber_stats(b_cols, with_min=True),
        *_fiber_hist(a_rows),
        *_fiber_hist(b_cols),
        a_band, a_diag, b_band, b_diag,
        *budget_feats,
        _log2(max(int(n_shards), 1)),
        math.log1p(pc["ip_m"] / pmin - 1.0),
        math.log1p(pc["op_m"] / pmin - 1.0),
        math.log1p(pc["gust_m"] / pmin - 1.0),
        math.log1p(pc["ip_n"] / pmin - 1.0),
        math.log1p(pc["op_n"] / pmin - 1.0),
        math.log1p(pc["gust_n"] / pmin - 1.0),
        _log2(pmin),
    ]
    out = np.asarray(feats, dtype=np.float32)
    assert out.shape == (N_FEATURES,), (out.shape, N_FEATURES)
    return out


def context_features(ctx) -> np.ndarray:
    """Feature vector of a :class:`repro_torch.backends.SelectionContext`.

    Per-tile contexts (``ctx.tile`` set) flow through the same extractor —
    their ``shape``/``occ_a``/``occ_b`` already describe the tile's own
    occupancy slice, and ``memory_budget`` is ``None`` by construction
    (the mixed scheduler shrank the tile until it was residency-feasible).
    """
    n_shards = 1
    if ctx.mesh is not None or ctx.partition is not None:
        n_shards = ctx.n_shards
    return pattern_features(ctx.shape, tuple(ctx.block_shape),
                            ctx.occ_a, ctx.occ_b,
                            memory_budget=ctx.memory_budget,
                            n_shards=n_shards)
