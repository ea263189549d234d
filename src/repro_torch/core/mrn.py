"""Functional model of the Merger-Reduction Network (paper §3.1, Fig. 4).

The MRN is an augmented binary tree whose nodes operate in one of two modes:

- **adder** — reduce a cluster of psums into one full sum (FAN-style, used by
  the IP dataflow);
- **comparator/merger** — merge coordinate-sorted psum fibers: equal
  coordinates accumulate, otherwise the lower coordinate advances (used by the
  OP/Gust merging phase).

On the CUDA datapath this structure disappears into the kernels' schedules;
this functional model backs the cycle-level simulator (work/occupancy counts
per tree pass) and the unit tests that check merge/reduce semantics — i.e.
that one substrate really can do both jobs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["MRNStats", "reduce_clusters", "merge_fibers", "mrn_passes"]


@dataclasses.dataclass
class MRNStats:
    """Work accounting for one MRN operation."""

    elements_in: int        # leaf elements fed into the tree
    elements_out: int       # elements emitted at the root
    node_ops: int           # adder/comparator activations
    passes: int             # tree passes (>1 when fibers > leaves)
    depth: int              # levels traversed


def _merge_two(fa: Tuple[np.ndarray, np.ndarray],
               fb: Tuple[np.ndarray, np.ndarray],
               stats: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Comparator-node semantics: 2-way sorted merge with accumulation.

    Vectorized equivalent of the element-at-a-time hardware walk; ``stats[0]``
    accumulates the number of comparator activations (= elements consumed).
    """
    ca, va = fa
    cb, vb = fb
    stats[0] += len(ca) + len(cb)
    if len(ca) == 0:
        return cb, vb
    if len(cb) == 0:
        return ca, va
    coords = np.concatenate([ca, cb])
    vals = np.concatenate([va, vb])
    order = np.argsort(coords, kind="stable")
    coords, vals = coords[order], vals[order]
    # accumulate duplicates (coordinate match -> adder half of the node)
    uniq, inv = np.unique(coords, return_inverse=True)
    out = np.zeros(len(uniq), dtype=vals.dtype)
    np.add.at(out, inv, vals)
    return uniq, out


def merge_fibers(
    fibers: Sequence[Tuple[np.ndarray, np.ndarray]],
    leaves: int = 64,
) -> Tuple[Tuple[np.ndarray, np.ndarray], MRNStats]:
    """Merge coordinate-sorted fibers through an MRN with ``leaves`` inputs.

    If more fibers than leaves arrive, the controller performs multiple passes
    (paper §3.2.2: "the controller needs to perform multiple passes to
    complete the final merge").
    """
    fibers = [
        (np.asarray(c), np.asarray(v))
        for c, v in fibers
    ]
    elements_in = sum(len(c) for c, _ in fibers)
    node_ops = [0]
    passes = 0
    while len(fibers) > 1:
        passes += 1
        batch, rest = fibers[:leaves], fibers[leaves:]
        # one tree pass: pairwise merge up log2(leaves) levels
        level = batch
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level) - 1, 2):
                nxt.append(_merge_two(level[i], level[i + 1], node_ops))
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        fibers = level + rest
    if not fibers:
        fibers = [(np.zeros(0, np.int64), np.zeros(0, np.float64))]
    out = fibers[0]
    depth = int(np.ceil(np.log2(max(2, leaves))))
    return out, MRNStats(elements_in, len(out[0]), node_ops[0], passes, depth)


def reduce_clusters(
    values: np.ndarray, cluster_sizes: Sequence[int], leaves: int = 64
) -> Tuple[np.ndarray, MRNStats]:
    """Adder-mode operation: reduce variable-sized psum clusters to full sums.

    Models FAN/ART-style non-blocking reduction — clusters mapped to adjacent
    leaves, each reduced in one pass through the tree.
    """
    values = np.asarray(values)
    assert sum(cluster_sizes) == len(values)
    out, off = [], 0
    node_ops = 0
    for sz in cluster_sizes:
        out.append(values[off: off + sz].sum())
        node_ops += max(0, sz - 1)
        off += sz
    passes = int(np.ceil(sum(cluster_sizes) / max(1, leaves)))
    depth = int(np.ceil(np.log2(max(2, leaves))))
    return np.asarray(out), MRNStats(len(values), len(out), node_ops, passes, depth)


def mrn_passes(n_fibers: int, leaves: int = 64) -> int:
    """Number of tree passes needed to merge ``n_fibers`` sorted fibers."""
    passes = 0
    while n_fibers > 1:
        merged = max(1, n_fibers // leaves) if n_fibers > leaves else 1
        n_fibers = merged + max(0, n_fibers - leaves)
        passes += 1
        if passes > 64:  # safety: cannot happen for sane inputs
            break
    return passes
