"""Labeled corpus generation: sweep the slow, accurate selectors.

A copy of ``repro.tune.corpus`` with the port's ``DeviceSpec`` in place of
``DeviceSpec``.  Its labels come from the port's ``SimulatorPolicy``, whose
picks equal the JAX package's, so the corpus is the reference's record for
record.  The port registers every arch of ``CONFIG_ARCHS``, so a full (not
``quick``) corpus holds the same config-derived records as JAX's,
mixtral-8x7b's included.

The training data for :class:`repro_torch.tune.learned.LearnedPolicy` is a
sweep of the repo's two *accurate* selection policies over a family of
patterns:

- **synthetic patterns** — uniform, banded, block-diagonal, dense-band +
  sparse remainder, column-skewed, and fully dense block bitmaps across a
  range of grids and densities (the structures the paper's workloads
  exhibit);
- **model-config shapes** — the FFN SpMSpM shapes of the
  ``repro_torch.configs`` registry archs (smoke variants, so corpus generation
  stays CPU-cheap) at several token counts and weight sparsities.

Each context is labeled by ``SimulatorPolicy.select`` (the paper's
phase-1-proper pricing; ``AutotunePolicy`` measurement labels are
optional via ``labeler=``), both as a whole operation and — for
budget-bearing contexts — per tile of the mixed schedule via
``select_tile``, so one corpus teaches both ``select`` entry points.

Records are JSON dicts (features + label + generation metadata) written
as JSONL; ``python -m repro_torch.tune corpus`` is the CLI face.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..backends.base import allowed_dataflows, get_backend
from ..backends.policies import SelectionContext, get_policy
from ..core.selector import DeviceSpec, LayerShape
from ..memory import MemoryBudget
from .features import FEATURE_NAMES, context_features

__all__ = ["PatternSpec", "generate_contexts", "tile_contexts",
           "generate_corpus", "save_corpus", "load_corpus", "split_corpus",
           "corpus_matrices"]

#: Synthetic block-occupancy families (see module docstring).
FAMILIES = ("uniform", "band", "block_diag", "dense_rows", "col_skew",
            "dense")

#: Smoke-config archs whose FFN shapes seed the config-derived contexts.
CONFIG_ARCHS = ("smollm-360m", "qwen2-1.5b", "mixtral-8x7b")


class PatternSpec:
    """Deterministic recipe for one context (regenerable from metadata)."""

    def __init__(self, family: str, grid_a: Tuple[int, int],
                 grid_b: Tuple[int, int], density_a: float, density_b: float,
                 seed: int, budget: Optional[Tuple[int, int]] = None,
                 origin: str = "synthetic"):
        self.family = family
        self.grid_a = grid_a
        self.grid_b = grid_b
        self.density_a = density_a
        self.density_b = density_b
        self.seed = seed
        self.budget = budget
        self.origin = origin

    def meta(self) -> Dict[str, Any]:
        return {"family": self.family, "grid_a": list(self.grid_a),
                "grid_b": list(self.grid_b), "density_a": self.density_a,
                "density_b": self.density_b, "seed": self.seed,
                "budget": list(self.budget) if self.budget else None,
                "origin": self.origin}


def _occupancy(family: str, grid: Tuple[int, int], density: float,
               rng: np.random.Generator) -> np.ndarray:
    """One block-occupancy bitmap of the named structural family."""
    rows, cols = grid
    if family == "dense":
        return np.ones(grid, dtype=bool)
    if family == "uniform":
        occ = rng.random(grid) < density
    elif family == "band":
        i = np.arange(rows)[:, None] / max(rows - 1, 1)
        j = np.arange(cols)[None, :] / max(cols - 1, 1)
        width = max(density, 0.05)
        occ = np.abs(i - j) <= width / 2
    elif family == "block_diag":
        i = np.arange(rows)[:, None]
        j = np.arange(cols)[None, :]
        blocks = max(2, int(round(1.0 / max(density, 0.1))))
        occ = (i * blocks // max(rows, 1)) == (j * blocks // max(cols, 1))
    elif family == "dense_rows":
        occ = rng.random(grid) < density * 0.4
        occ[: max(1, rows // 3)] = True
    elif family == "col_skew":
        col_p = density * 2.0 * (0.5 ** (np.arange(cols)
                                         / max(cols / 4.0, 1.0)))
        occ = rng.random(grid) < np.clip(col_p, 0.01, 1.0)[None, :]
    else:
        raise ValueError(f"unknown pattern family {family!r}")
    # an all-empty operand has no dataflow question to answer
    if not occ.any():
        occ[rng.integers(rows), rng.integers(cols)] = True
    return occ


def _context_of(spec: PatternSpec, backend, block_shape: Tuple[int, int, int],
                device_spec: DeviceSpec) -> SelectionContext:
    rng = np.random.default_rng(spec.seed)
    occ_a = _occupancy(spec.family, spec.grid_a, spec.density_a, rng)
    occ_b = _occupancy("uniform" if spec.family == "dense" else spec.family,
                       spec.grid_b, spec.density_b, rng)
    bm, bk, bn = block_shape
    shape = LayerShape(
        m=spec.grid_a[0] * bm, k=spec.grid_a[1] * bk,
        n=spec.grid_b[1] * bn,
        density_a=float(occ_a.mean()), density_b=float(occ_b.mean()),
        block=tuple(block_shape))
    budget = None
    if spec.budget is not None:
        budget = MemoryBudget(l1_bytes=spec.budget[0],
                              l2_bytes=spec.budget[1])
    allowed = allowed_dataflows(backend, tuple(block_shape))
    fingerprint = (f"corpus:{spec.origin}:{spec.family}:{spec.seed}"
                   f":{spec.grid_a}:{spec.grid_b}")
    return SelectionContext(shape=shape, block_shape=tuple(block_shape),
                            occ_a=occ_a, occ_b=occ_b,
                            fingerprint=fingerprint, backend=backend,
                            spec=device_spec, allowed=allowed,
                            memory_budget=budget)


def _synthetic_specs(n: int, rng: np.random.Generator, *, quick: bool,
                     block_shape: Tuple[int, int, int],
                     budget_fraction: float = 0.35,
                     max_grid: Optional[int] = None) -> Iterator[PatternSpec]:
    bm, bk, bn = block_shape
    if max_grid is None:
        max_grid = 8 if quick else 20
    for i in range(n):
        family = FAMILIES[int(rng.integers(len(FAMILIES)))]
        ma = int(rng.integers(3, max_grid + 1))
        ka = int(rng.integers(3, max_grid + 1))
        na = int(rng.integers(3, max_grid + 1))
        da = float(rng.choice([0.05, 0.1, 0.2, 0.35, 0.5, 0.7, 0.9]))
        db = float(rng.choice([0.05, 0.1, 0.2, 0.35, 0.5, 0.7, 0.9]))
        budget = None
        if rng.random() < budget_fraction:
            # scale the budget to the pattern so tiling actually engages:
            # a handful of blocks stationary, a few stripes streamed
            blk = bm * bk * 4
            budget = (int(blk * rng.integers(2, 8)),
                      int(blk * rng.integers(4, 16)))
        yield PatternSpec(family, (ma, ka), (ka, na), da, db,
                          seed=int(rng.integers(2 ** 31)), budget=budget)


def _config_specs(rng: np.random.Generator, *, quick: bool,
                  block_shape: Tuple[int, int, int]) -> Iterator[PatternSpec]:
    """FFN SpMSpM shapes of the registry archs (smoke variants)."""
    from ..configs import get_config

    bm, bk, bn = block_shape
    archs = CONFIG_ARCHS[:1] if quick else CONFIG_ARCHS
    token_counts = (16,) if quick else (16, 64, 256)
    for arch in archs:
        try:
            cfg = get_config(arch, smoke=True)
        except KeyError:            # registry drift: skip, don't die
            continue
        for tokens in token_counts:
            for density in (0.15, 0.4, 0.8):
                grid_a = (-(-tokens // bm), -(-cfg.d_model // bk))
                grid_b = (-(-cfg.d_model // bk), -(-cfg.d_ff // bn))
                yield PatternSpec(
                    "uniform", grid_a, grid_b, 1.0, density,
                    seed=int(rng.integers(2 ** 31)),
                    origin=f"config:{arch}:t{tokens}")


def generate_contexts(n_synthetic: int = 120, *, quick: bool = False,
                      backend="reference",
                      block_shape: Tuple[int, int, int] = (16, 16, 16),
                      device_spec: DeviceSpec = DeviceSpec(),
                      include_configs: bool = True, seed: int = 0,
                      max_grid: Optional[int] = None,
                      budget_fraction: float = 0.35
                      ) -> List[Tuple[SelectionContext, Dict[str, Any]]]:
    """(context, metadata) pairs — the corpus inputs, before labeling.

    Deterministic for a fixed ``seed``: tests and the CLI's held-out eval
    regenerate disjoint context sets by varying the seed alone.
    ``max_grid`` overrides the synthetic grid ceiling (default 8 quick /
    20 full) — the latency benchmarks use large grids, where the
    simulator has to sample and price big element patterns.
    """
    backend = get_backend(backend)
    rng = np.random.default_rng(np.random.SeedSequence([seed, n_synthetic]))
    specs = list(_synthetic_specs(n_synthetic, rng, quick=quick,
                                  block_shape=block_shape,
                                  budget_fraction=budget_fraction,
                                  max_grid=max_grid))
    if include_configs:
        specs.extend(_config_specs(rng, quick=quick, block_shape=block_shape))
    return [(_context_of(s, backend, block_shape, device_spec), s.meta())
            for s in specs]


def tile_contexts(ctx: SelectionContext) -> List[SelectionContext]:
    """Per-tile contexts of ``ctx``'s mixed schedule (budget contexts only).

    Mirrors :func:`repro_torch.memory.tiled_plan.mixed_tile_dataflows`: the same
    tile slices, shapes, and budget-free per-tile contexts the mixed
    planner hands to ``select_tile`` — so tile labels train exactly the
    entry point the planner calls.
    """
    from ..memory.tiling import schedule

    if ctx.memory_budget is None:
        return []
    tiles, _ = schedule("mixed", ctx.occ_a, ctx.occ_b, ctx.block_shape,
                        ctx.memory_budget)
    if len(tiles) <= 1:
        return []
    bm, bk, bn = ctx.block_shape
    out = []
    for idx, tile in enumerate(tiles):
        occ_at = tile.a_slice(ctx.occ_a)
        occ_bt = tile.b_slice(ctx.occ_b)
        shape = LayerShape(
            m=(tile.i1 - tile.i0) * bm, k=(tile.k1 - tile.k0) * bk,
            n=(tile.j1 - tile.j0) * bn,
            density_a=float(occ_at.mean()) if occ_at.size else 0.0,
            density_b=float(occ_bt.mean()) if occ_bt.size else 0.0,
            block=tuple(ctx.block_shape))
        out.append(SelectionContext(
            shape=shape, block_shape=tuple(ctx.block_shape), occ_a=occ_at,
            occ_b=occ_bt, fingerprint=f"{ctx.fingerprint}/tile{idx}",
            backend=ctx.backend, spec=ctx.spec, allowed=ctx.allowed,
            tile=tile))
    return out


def _label(policy, ctx: SelectionContext) -> Tuple[str, Optional[float]]:
    """(label, margin): margin is the runner-up's relative cost slack.

    A margin near zero means the labeler itself is indifferent — the
    label is a tie-break, not a preference, and teaching (or scoring) a
    model on it is noise.  ``generate_corpus(min_margin=...)`` filters on
    this.  Policies without a ``price`` method (e.g. autotune labels its
    choice by measurement) yield ``margin=None``.
    """
    price = getattr(policy, "price", None)
    if price is None:
        return policy.select(ctx), None
    costs = price(ctx)
    ranked = sorted(costs.items(), key=lambda kv: (kv[1], kv[0]))
    if len(ranked) < 2:
        return ranked[0][0], None
    (best, c0), (_, c1) = ranked[0], ranked[1]
    return best, (c1 - c0) / max(c0, 1e-12)


def generate_corpus(n_synthetic: int = 120, *, quick: bool = False,
                    labeler="simulator", backend="reference",
                    block_shape: Tuple[int, int, int] = (16, 16, 16),
                    include_configs: bool = True, include_tiles: bool = True,
                    seed: int = 0, max_tiles_per_context: int = 8,
                    min_margin: float = 0.0) -> List[Dict[str, Any]]:
    """Sweep ``labeler`` over generated contexts → labeled examples.

    ``labeler`` is any :class:`repro_torch.backends.SelectionPolicy` (or name):
    ``"simulator"`` is the default source of truth; pass an
    ``AutotunePolicy`` for measured labels.  Budget-bearing contexts also
    contribute per-tile examples (``kind="tile"``), labeled through
    per-tile pricing — capped at ``max_tiles_per_context`` so one huge
    schedule cannot dominate the class balance.

    ``min_margin`` drops examples where the labeler's best and runner-up
    candidates are within that relative cost slack of each other: those
    labels are tie-breaks (either choice performs the same), so they add
    class noise without adding signal.  Every kept record still carries
    its ``margin`` so downstream splits can re-filter.

    Budget-bearing contexts contribute **per-tile** labels only: under a
    budget the planner tiles the operation and selects per tile
    (``select_tile``), which is exactly what the tile examples train.
    The whole-operation label under a budget prices a different model
    (:func:`repro_torch.memory.traffic.tiled_traffic`, which re-runs the
    scheduler per candidate) that no microsecond feature vector predicts
    reliably — ``LearnedPolicy.select`` falls back to its slow-but-sound
    fallback policy there instead of guessing.
    """
    policy = get_policy(labeler)
    contexts = generate_contexts(n_synthetic, quick=quick, backend=backend,
                                 block_shape=block_shape,
                                 include_configs=include_configs, seed=seed)
    examples: List[Dict[str, Any]] = []
    for group, (ctx, meta) in enumerate(contexts):
        if ctx.memory_budget is None:
            label, margin = _label(policy, ctx)
            if margin is None or margin >= min_margin:
                feats = context_features(ctx)
                examples.append({"features": [float(f) for f in feats],
                                 "label": label, "kind": "whole",
                                 "margin": margin, "group": group, **meta})
        if include_tiles:
            for tctx in tile_contexts(ctx)[:max_tiles_per_context]:
                tlabel, tmargin = _label(policy, tctx)
                if tmargin is not None and tmargin < min_margin:
                    continue
                tfeats = context_features(tctx)
                examples.append({"features": [float(f) for f in tfeats],
                                 "label": tlabel, "kind": "tile",
                                 "margin": tmargin, "group": group, **meta,
                                 "tile": tctx.fingerprint.rsplit("/", 1)[-1]})
    return examples


# -- serialization -----------------------------------------------------------


def save_corpus(path: str, examples: Sequence[Dict[str, Any]]) -> None:
    """JSONL with a header line carrying the feature layout (versioning)."""
    with open(path, "w") as f:
        f.write(json.dumps({"_header": 1,
                            "feature_names": list(FEATURE_NAMES)}) + "\n")
        for ex in examples:
            f.write(json.dumps(ex) + "\n")


def load_corpus(path: str) -> List[Dict[str, Any]]:
    examples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "_header" in rec:
                if tuple(rec["feature_names"]) != FEATURE_NAMES:
                    raise ValueError(
                        f"corpus at {path!r} uses a different feature "
                        "layout; regenerate with `python -m repro_torch.tune "
                        "corpus`")
                continue
            examples.append(rec)
    return examples


def split_corpus(examples: Sequence[Dict[str, Any]], held_out: float = 0.25,
                 seed: int = 0) -> Tuple[List[dict], List[dict]]:
    """Deterministic (train, held_out) split, grouped by source context.

    Tiles of one schedule share their parent pattern; splitting them
    across train/test would leak near-duplicate examples into the
    held-out set and flatter the agreement number.  All examples carrying
    the same ``group`` (one generated context) land on the same side.
    """
    groups = sorted({ex.get("group", i) for i, ex in enumerate(examples)})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(groups))
    n_test = max(1, int(round(len(groups) * held_out)))
    test_groups = {groups[int(i)] for i in order[:n_test]}
    train, test = [], []
    for i, ex in enumerate(examples):
        (test if ex.get("group", i) in test_groups else train).append(ex)
    return train, test


def corpus_matrices(examples: Sequence[Dict[str, Any]]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) arrays; labels are indices into ``learned.CLASSES``."""
    from .learned import CLASSES

    X = np.asarray([ex["features"] for ex in examples], np.float32)
    y = np.asarray([CLASSES.index(ex["label"]) for ex in examples], np.int64)
    return X, y
