"""Unified streaming work-list substrate for the Flexagon CUDA kernels.

All three dataflows enumerate the *same* effectual set
``{(i, k, j) : A[i,k] != 0 and B[k,j] != 0}`` — they differ only in the
order the pairs are visited and in the merge discipline applied to the
resulting psum blocks (paper §3.2).  This module factors that observation
into one phase-1 artifact, :class:`StreamSchedule`: a flat work list of
(A slot, B slot) block pairs annotated with run boundaries, consumed by
exactly two kernels:

- :func:`stream_spmm` — the *block-run* kernel (K1).  Work entries arrive
  destination-major (IP keeps its intersection order; OP is lexsorted by
  destination at plan time), so the merge degenerates to "accumulate while
  the run is unchanged, write when it ends".
- :func:`stream_panel_spmm` — the *row-panel* kernel (K2, Gustavson).
  Work entries arrive row-major; each psum merges into the run's output
  row panel at its follower's column.

The host half (:class:`StreamSchedule`, :func:`schedule_from_ip`,
:func:`schedule_from_stream`, :func:`pad_schedule`) is numpy and builds
arrays byte-equal to ``repro.kernels.stream``.  :func:`device_schedule`
uploads what the kernels read — the work list, one segment table of run
starts and destinations derived from ``is_first``, and K1's chunk table
(:func:`chunk_table`), which cuts long segments into chunks so that a plan
with few runs still fills the card — to a device once per plan.  A panel
schedule also gets K2's :class:`ColumnTable` (:func:`column_table`): each
run's entries regrouped by destination column block, so that K2 walks one
output tile's entries destination-major, as K1 does, with its own chunks.

B reaches either kernel in one of two forms: a stack of ``(bk, bn)``
blocks, or, with ``b_coords=`` (:class:`BlockCoords`, built once per plan
by :func:`block_coords`), the dense ``(K, N)`` operand itself, which the
kernel reads in place through each block slot's coordinates: no gather
runs, and the sums are the stack form's, bit for bit.

Each wrapper dispatches on the device of its operands alone: a tensor on
the CPU runs the plain PyTorch version in this module
(:func:`stream_spmm_plain`, :func:`stream_panel_spmm_plain`); a tensor
anywhere else launches the CUDA kernel (``csrc/stream_spmm.cu``) or
raises.  ``stream_spmm.launches`` / ``stream_panel_spmm.launches`` count
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.dataflows import IPPlan, StreamPlan
from ..core.formats import blockize
from . import build

__all__ = [
    "SCHEDULE_KINDS",
    "StreamSchedule",
    "DeviceSchedule",
    "ColumnTable",
    "BlockCoords",
    "block_coords",
    "schedule_from_ip",
    "schedule_from_stream",
    "pad_schedule",
    "device_schedule",
    "chunk_size",
    "chunk_table",
    "column_table",
    "dest_rows",
    "stream_spmm",
    "stream_spmm_plain",
    "stream_panel_spmm",
    "stream_panel_spmm_plain",
]

#: the two kernel disciplines a schedule can target: ``"dest"`` is the
#: destination-major block-run kernel (:func:`stream_spmm`, IP/OP),
#: ``"panel"`` the row-panel kernel (:func:`stream_panel_spmm`, Gustavson).
SCHEDULE_KINDS = ("dest", "panel")


@dataclasses.dataclass
class StreamSchedule:
    """Phase-1 work list + run boundaries for the streaming kernels.

    Pattern-only, numpy.  Runs are contiguous in the work list: entry ``w``
    starts a run when ``is_first[w]`` and ends one when ``is_last[w]``.
    """

    a_slot: np.ndarray     # (W,) int32 — A block slot per work entry
    b_slot: np.ndarray     # (W,) int32 — B block slot per work entry
    cj: np.ndarray         # (W,) int32 — destination block column (panel merge)
    is_first: np.ndarray   # (W,) int32 — run boundary flags
    is_last: np.ndarray
    run_id: np.ndarray     # (W,) int32 — output fiber index per entry
    run_ci: np.ndarray     # (R,) int32 — destination block coords per run
    run_cj: np.ndarray     # (R,) int32
    n_runs: int            # == R
    # -- self-description: which entries and runs are real, and the row
    # that padding targets (-1: the schedule carries no padding)
    kind: str = "dest"            # which kernel consumes it (SCHEDULE_KINDS)
    real_w: np.ndarray = None     # (1,) int32 — work entries that are real
    real_r: np.ndarray = None     # (1,) int32 — runs with real destinations
    oob: np.ndarray = None        # (1,) int32 — designated dropped pad row

    def __post_init__(self):
        if self.kind not in SCHEDULE_KINDS:
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if self.real_w is None:
            self.real_w = np.array([np.asarray(self.a_slot).size], np.int32)
        if self.real_r is None:
            self.real_r = np.array([self.n_runs], np.int32)
        if self.oob is None:
            self.oob = np.array([-1], np.int32)

    @property
    def n_work(self) -> int:
        return int(np.asarray(self.a_slot).size)

    @property
    def n_real_work(self) -> int:
        return int(np.asarray(self.real_w).reshape(-1)[0])

    @property
    def n_real_runs(self) -> int:
        return int(np.asarray(self.real_r).reshape(-1)[0])

    @property
    def oob_row(self) -> int:
        return int(np.asarray(self.oob).reshape(-1)[0])

    def describe(self) -> dict:
        """The self-description contract as one plain dict."""
        return {
            "kind": self.kind,
            "n_work": self.n_work,
            "n_runs": int(self.n_runs),
            "real_w": self.n_real_work,
            "real_r": self.n_real_runs,
            "oob_row": self.oob_row,
        }


def _empty_schedule(kind: str = "dest") -> StreamSchedule:
    z = np.zeros(0, np.int32)
    return StreamSchedule(z, z, z, z, z, z, z, z, 0, kind)


def _runs_from_boundaries(newrun: np.ndarray, w: int):
    is_first = np.ones(w, np.int32)
    is_first[1:] = newrun.astype(np.int32)
    is_last = np.ones(w, np.int32)
    is_last[:-1] = newrun.astype(np.int32)
    run_id = (np.cumsum(is_first) - 1).astype(np.int32)
    return is_first, is_last, run_id


def schedule_from_ip(plan: IPPlan) -> StreamSchedule:
    """IP: intersection lists are already destination-major (i, j, p)."""
    pair_a = np.asarray(plan.pair_a)
    pair_b = np.asarray(plan.pair_b)
    npairs = np.asarray(plan.npairs)
    mb, nb, p_max = pair_a.shape
    mask = np.arange(p_max)[None, None, :] < npairs[..., None]
    w = int(mask.sum())
    if w == 0:
        return _empty_schedule()
    a_slot = pair_a[mask].astype(np.int32)
    b_slot = pair_b[mask].astype(np.int32)
    ri, rj = np.nonzero(npairs)
    counts = npairs[ri, rj]
    cj = np.repeat(rj, counts).astype(np.int32)
    is_first = np.zeros(w, np.int32)
    is_first[np.cumsum(counts) - counts] = 1
    is_last = np.zeros(w, np.int32)
    is_last[np.cumsum(counts) - 1] = 1
    run_id = np.repeat(np.arange(ri.size), counts).astype(np.int32)
    return StreamSchedule(a_slot, b_slot, cj, is_first, is_last, run_id,
                          ri.astype(np.int32), rj.astype(np.int32),
                          int(ri.size), "dest")


def schedule_from_stream(plan: StreamPlan, *, by_dest: bool) -> StreamSchedule:
    """OP/Gust: order a :class:`StreamPlan` work list into runs.

    ``by_dest=True`` (OP) lexsorts the k-major psum stream by destination
    block — the PSRAM set/tag lookup as a host sort — so one kernel merges
    with no psum round trip through device memory.  ``by_dest=False``
    (Gust) keeps the i-major leader/follower order and forms one run per
    output row panel.
    """
    ci = np.asarray(plan.ci)
    cj = np.asarray(plan.cj)
    a_slot = np.asarray(plan.a_slot).astype(np.int32)
    b_slot = np.asarray(plan.b_slot).astype(np.int32)
    kind = "dest" if by_dest else "panel"
    w = int(ci.size)
    if w == 0:
        return _empty_schedule(kind)
    # seg_ptr[-1] counts the plan's real entries; padded entries (which
    # only tiled plans make) carry an out-of-bounds ci and sort last
    real = int(np.asarray(plan.seg_ptr)[-1])
    if by_dest:
        order = np.lexsort((cj, ci))
        ci, cj = ci[order], cj[order]
        a_slot, b_slot = a_slot[order], b_slot[order]
        newrun = (ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])
    else:
        newrun = ci[1:] != ci[:-1]
    is_first, is_last, run_id = _runs_from_boundaries(newrun, w)
    run_ci = ci[is_first == 1].astype(np.int32)
    run_cj = (cj[is_first == 1] if by_dest
              else np.zeros(run_ci.size)).astype(np.int32)
    real_r = int(run_id[real - 1]) + 1 if real > 0 else 0
    oob = int(ci[real]) if real < w else -1
    return StreamSchedule(a_slot, b_slot, cj.astype(np.int32),
                          is_first, is_last, run_id,
                          run_ci, run_cj, int(run_ci.size), kind,
                          np.array([real], np.int32),
                          np.array([real_r], np.int32),
                          np.array([oob], np.int32))


def pad_schedule(s: StreamSchedule, w_total: int, r_total: int,
                 oob_row: int) -> StreamSchedule:
    """Pad a schedule to shared (work, run) extents.

    Pad work entries are each a self-contained single-entry run (reset,
    one add of real-but-irrelevant blocks, flush) targeting the reserved
    run slot ``r_total - 1``; every pad run slot's destination row is
    ``oob_row`` (one past the output grid), so the kernels skip it.
    """
    w = int(np.asarray(s.a_slot).size)
    wpad = w_total - w
    rpad = r_total - s.n_runs
    if wpad < 0 or rpad < 0 or (wpad > 0 and rpad == 0):
        raise ValueError(
            f"cannot pad schedule (W={w}, R={s.n_runs}) to "
            f"(W={w_total}, R={r_total})")
    if wpad == 0 and rpad == 0:
        return s
    if s.oob_row >= 0 and s.oob_row != oob_row:
        raise ValueError(
            f"conflicting pad destinations: schedule already pads to row "
            f"{s.oob_row}, pad_schedule asked for {oob_row}")
    zero = np.zeros(wpad, np.int32)
    one = np.ones(wpad, np.int32)
    return StreamSchedule(
        np.concatenate([np.asarray(s.a_slot, np.int32), zero]),
        np.concatenate([np.asarray(s.b_slot, np.int32), zero]),
        np.concatenate([np.asarray(s.cj, np.int32), zero]),
        np.concatenate([np.asarray(s.is_first, np.int32), one]),
        np.concatenate([np.asarray(s.is_last, np.int32), one]),
        np.concatenate([np.asarray(s.run_id, np.int32),
                        np.full(wpad, r_total - 1, np.int32)]),
        np.concatenate([np.asarray(s.run_ci, np.int32),
                        np.full(rpad, oob_row, np.int32)]),
        np.concatenate([np.asarray(s.run_cj, np.int32),
                        np.zeros(rpad, np.int32)]),
        r_total,
        s.kind,
        np.asarray(s.real_w, np.int32),
        np.asarray(s.real_r, np.int32),
        np.array([oob_row], np.int32),
    )


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------


#: K1's and K2's chunking: the work list is cut into about this many
#: chunks (two per SM of the H100), and no chunk of a split segment is
#: shorter than MIN_CHUNK entries
TARGET_CHUNKS = 2 * 132
MIN_CHUNK = 4


def chunk_size(n_work: int) -> int:
    """Most entries of one chunk for a work list of ``n_work`` entries:
    about ``n_work / TARGET_CHUNKS``, at least :data:`MIN_CHUNK`.  Plans
    with many short runs then split nothing; plans with few long runs
    split each into pieces of the same size."""
    return max(MIN_CHUNK, -(-n_work // TARGET_CHUNKS))


def chunk_table(seg_start: np.ndarray, chunk: int):
    """Cut each segment's entries into chunks of at most ``chunk`` entries.

    ``seg_start`` is the (S+1,) segment offset table.  Returns int32 arrays
    ``(chunk_start, chunk_seg, chunk_slot, split_seg, split_start)``:

    - ``chunk_start`` (C+1,): chunk offsets in the work list; chunks cover
      it in order, each inside one segment, last == W;
    - ``chunk_seg`` (C,): the segment of each chunk;
    - ``chunk_slot`` (C,): the workspace slot of a chunk of a segment cut
      into several, numbered in chunk order; -1 for a segment of one chunk,
      which the kernel writes straight into C;
    - ``split_seg`` (P,): the segments cut into several chunks, in order;
    - ``split_start`` (P+1,): each one's first slot; their chunks' slots
      run from there to the next, in chunk order.
    """
    seg_start = np.asarray(seg_start, np.int64)
    lengths = np.diff(seg_start)
    pieces = np.maximum(1, -(-lengths // chunk))          # chunks per segment
    chunk_seg = np.repeat(np.arange(lengths.size), pieces)
    first = np.cumsum(pieces) - pieces                    # segment's 1st chunk
    nth = np.arange(chunk_seg.size) - first[chunk_seg]
    chunk_start = np.append(seg_start[:-1][chunk_seg] + nth * chunk,
                            seg_start[-1])
    split = pieces > 1
    in_split = split[chunk_seg]
    chunk_slot = np.full(chunk_seg.size, -1, np.int64)
    chunk_slot[in_split] = np.arange(int(in_split.sum()))
    split_seg = np.flatnonzero(split)
    split_start = np.append(0, np.cumsum(pieces[split]))
    return tuple(np.ascontiguousarray(x, np.int32) for x in
                 (chunk_start, chunk_seg, chunk_slot, split_seg, split_start))


def column_table(seg_start: np.ndarray, seg_ci: np.ndarray, cj: np.ndarray,
                 real: np.ndarray):
    """Regroup a panel schedule's entries by destination tile (K2).

    ``seg_start`` (S+1,) and ``seg_ci`` (S,) are the segment table, ``cj``
    (W,) each entry's destination column block, ``real`` (S,) bool the
    segments that write C (pad runs do not).  Returns int32 arrays
    ``(order, col_start, col_ci, col_cj)``:

    - ``order`` (V,): the real segments' entries, sorted stably by
      (segment, ``cj``), so that within one column block they keep their
      work-list order, the order in which the TPU kernel adds them;
    - ``col_start`` (G+1,): the *column segments*, the maximal stretches of
      ``order`` with one (segment, ``cj``), last == V;
    - ``col_ci``, ``col_cj`` (G,): each column segment's output tile.
    """
    seg_start = np.asarray(seg_start, np.int64)
    seg_of = np.repeat(np.arange(seg_start.size - 1), np.diff(seg_start))
    cj = np.asarray(cj, np.int64)
    mine = np.flatnonzero(np.asarray(real, bool)[seg_of])
    order = mine[np.lexsort((cj[mine], seg_of[mine]))]   # lexsort is stable
    seg, col = seg_of[order], cj[order]
    new = np.ones(order.size, bool)
    new[1:] = (seg[1:] != seg[:-1]) | (col[1:] != col[:-1])
    first = np.flatnonzero(new)
    return tuple(np.ascontiguousarray(x, np.int32) for x in
                 (order, np.append(first, order.size),
                  np.asarray(seg_ci)[seg[first]], col[first]))


def dest_rows(bm: int, m: int) -> int:
    """Sub-tile rows of K1 and K2: the least of 16, 32 and 64 that covers a
    block's valid rows, ``min(bm, m)`` (64 above that, in several
    sub-tiles)."""
    valid = min(bm, m)
    return 16 if valid <= 16 else 32 if valid <= 32 else 64


@dataclasses.dataclass
class ColumnTable:
    """K2's walk of a panel schedule, on one device (:func:`column_table`).

    One column segment holds the entries that sum into one output tile
    ``(col_ci, col_cj)``, in work-list order (``order`` is
    :func:`column_table`'s).  Pad runs have none, and a
    tile that no entry touches has none: it stays zero.  The chunk table
    cuts the column segments as :func:`chunk_table` cuts K1's segments.
    """

    a_slot: torch.Tensor        # (V,) int32 — the schedule's a_slot[order]
    b_slot: torch.Tensor        # (V,) int32 — the schedule's b_slot[order]
    col_start: torch.Tensor     # (G+1,) int32 — column segment offsets
    col_ci: torch.Tensor        # (G,) int32 — destination block row
    col_cj: torch.Tensor        # (G,) int32 — destination block column
    # chunk table over the column segments (see chunk_table)
    chunk_start: torch.Tensor   # (C+1,) int32
    chunk_seg: torch.Tensor     # (C,) int32 — the chunk's column segment
    chunk_slot: torch.Tensor    # (C,) int32 — workspace slot or -1
    split_seg: torch.Tensor     # (P,) int32
    split_start: torch.Tensor   # (P+1,) int32
    n_slots: int                # workspace slots == split_start[-1]

    @property
    def n_seg(self) -> int:
        """Column segments: output tiles that some entry touches."""
        return int(self.col_ci.shape[0])

    @property
    def n_chunk(self) -> int:
        return int(self.chunk_seg.shape[0])

    @property
    def n_split(self) -> int:
        return int(self.split_seg.shape[0])


@dataclasses.dataclass
class DeviceSchedule:
    """What the kernels read, on one device.  Built once per plan.

    A *segment* is one run as the work list lays it out: the entries from
    one ``is_first`` to the next.  Real runs are one segment each; every
    pad entry of :func:`pad_schedule` is a segment of its own whose
    destination row is out of bounds.  K1 reads the segments through the
    chunk table of :func:`chunk_table`; K2 reads a panel schedule through
    its :class:`ColumnTable` (``cols``), cut at the same ``chunk``.
    """

    a_slot: torch.Tensor      # (W,) int32
    b_slot: torch.Tensor      # (W,) int32
    cj: torch.Tensor          # (W,) int32
    seg_start: torch.Tensor   # (S+1,) int32 — segment offsets, last == W
    seg_ci: torch.Tensor      # (S,) int32 — destination block row
    seg_cj: torch.Tensor      # (S,) int32 — destination block column
    kind: str
    # host-side bounds, checked against the operands before every launch
    max_a_slot: int
    max_b_slot: int
    max_cj: int
    # K1's chunk table (see chunk_table), cut at ``chunk`` entries
    chunk_start: torch.Tensor   # (C+1,) int32
    chunk_seg: torch.Tensor     # (C,) int32
    chunk_slot: torch.Tensor    # (C,) int32 — workspace slot or -1
    split_seg: torch.Tensor     # (P,) int32
    split_start: torch.Tensor   # (P+1,) int32
    chunk: int
    n_slots: int                # workspace slots == split_start[-1]
    cols: ColumnTable = None    # K2's table; None for a "dest" schedule

    @property
    def n_work(self) -> int:
        return int(self.a_slot.shape[0])

    @property
    def n_seg(self) -> int:
        return int(self.seg_ci.shape[0])

    @property
    def n_chunk(self) -> int:
        return int(self.chunk_seg.shape[0])

    @property
    def n_split(self) -> int:
        """Segments cut into several chunks (K1's second pass sums them)."""
        return int(self.split_seg.shape[0])

    @property
    def device(self) -> torch.device:
        return self.a_slot.device


def device_schedule(s: StreamSchedule, device, *,
                    chunk: int = None) -> DeviceSchedule:
    """Derive the segment and chunk tables from ``is_first`` (and, for a
    panel schedule, K2's column table) and upload them once.  ``chunk``
    (default :func:`chunk_size` of the work list) is the most entries of
    one chunk, in both kernels."""
    is_first = np.asarray(s.is_first)
    w = int(is_first.size)
    if w and is_first[0] != 1:
        raise ValueError("malformed schedule: entry 0 does not start a run")
    starts = np.flatnonzero(is_first)
    rid = np.asarray(s.run_id)[starts]
    seg_ci = np.asarray(s.run_ci, np.int32)[rid]
    seg_cj = np.asarray(s.run_cj, np.int32)[rid]
    cj = np.asarray(s.cj, np.int32)
    seg_start = np.append(starts, w)
    chunk = chunk_size(w) if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=device)

    def top(x):
        return int(x.max()) if x.size else -1

    a_slot = np.asarray(s.a_slot, np.int32)
    b_slot = np.asarray(s.b_slot, np.int32)
    if w and min(int(a_slot.min()), int(b_slot.min())) < 0:
        raise ValueError("malformed schedule: negative block slot")
    chunks = chunk_table(seg_start, chunk)
    cols = None
    if s.kind == "panel":
        # pad runs aim at the schedule's out-of-bounds row (one past the
        # output grid): K2's table leaves them out, as the JAX scatter
        # drops them
        real = seg_ci >= 0
        if s.oob_row >= 0:
            real &= seg_ci < s.oob_row
        order, col_start, col_ci, col_cj = column_table(seg_start, seg_ci,
                                                        cj, real)
        col_chunks = chunk_table(col_start, chunk)
        cols = ColumnTable(up(a_slot[order]), up(b_slot[order]),
                           up(col_start), up(col_ci), up(col_cj),
                           *(up(x) for x in col_chunks),
                           int(col_chunks[4][-1]))
    return DeviceSchedule(
        up(a_slot), up(b_slot), up(cj),
        up(seg_start), up(seg_ci), up(seg_cj), s.kind,
        top(a_slot), top(b_slot),
        top(cj) if s.kind == "panel" else top(seg_cj),
        *(up(x) for x in chunks), chunk, int(chunks[4][-1]), cols)


@dataclasses.dataclass
class BlockCoords:
    """Where each block slot of a ``(K, N)`` operand's block layout lies
    in the dense operand, on one device: what K1 and K2 read a dense B in
    place through.  Built once per plan (:func:`block_coords`)."""

    rows: torch.Tensor          # (nnzb,) int32 — block row of each slot
    cols: torch.Tensor          # (nnzb,) int32 — block column of each slot
    shape: Tuple[int, int]      # (K, N) of the dense operand
    block_shape: Tuple[int, int]   # (bk, bn)

    @property
    def nnzb(self) -> int:
        return int(self.rows.shape[0])

    @property
    def grid(self) -> Tuple[int, int]:
        (k, n), (bk, bn) = self.shape, self.block_shape
        return -(-k // bk), -(-n // bn)


def block_coords(rows, cols, shape, block_shape, device) -> BlockCoords:
    """Upload a block layout's slot coordinates (``rows``/``cols``, host
    arrays in slot order) as int32 tables on ``device``."""
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    grid = (-(-shape[0] // block_shape[0]), -(-shape[1] // block_shape[1]))
    if rows.shape != cols.shape or (rows.size and (
            min(rows.min(), cols.min()) < 0 or rows.max() >= grid[0]
            or cols.max() >= grid[1])):
        raise ValueError(f"block coordinates outside the {grid} grid")
    return BlockCoords(torch.as_tensor(rows, device=device),
                       torch.as_tensor(cols, device=device),
                       (int(shape[0]), int(shape[1])),
                       (int(block_shape[0]), int(block_shape[1])))


def _b_blocks(b_data, b_coords):
    """B as a block stack: ``b_data`` itself, or read from the dense
    operand through ``b_coords``, zero-padded at the ragged edges."""
    if b_coords is None:
        return b_data
    return blockize(b_data, b_coords.block_shape)[b_coords.rows.long(),
                                                  b_coords.cols.long()]


def _psums(a_data, b_data, ds: DeviceSchedule):
    """Per-entry block products and each entry's segment index."""
    psums = torch.bmm(a_data.float()[ds.a_slot], b_data.float()[ds.b_slot])
    seg_of = torch.repeat_interleave(
        torch.arange(ds.n_seg, device=ds.device),
        (ds.seg_start[1:] - ds.seg_start[:-1]).long())
    return psums, seg_of


def _crop(c, out_shape):
    mb, nb, bm, bn = c.shape
    c = c.transpose(1, 2).reshape(mb * bm, nb * bn)
    return c[: out_shape[0], : out_shape[1]]


def stream_spmm_plain(a_data: torch.Tensor, b_data: torch.Tensor,
                      ds: DeviceSchedule, *, out_grid: Tuple[int, int],
                      out_shape: Tuple[int, int],
                      b_coords: BlockCoords = None) -> torch.Tensor:
    """K1 in plain PyTorch: sum each segment, place it at its destination.

    Segments sum with ``index_add_``, sequential on the CPU and with
    atomics on a card, so it agrees with the kernel to fp32 rounding.
    With ``b_coords``, ``b_data`` is the dense B, its blocks taken through
    the coordinates.
    """
    b_data = _b_blocks(b_data, b_coords)
    mb, nb = out_grid
    bm, bn = a_data.shape[1], b_data.shape[2]
    c = torch.zeros((mb, nb, bm, bn), dtype=torch.float32,
                    device=a_data.device)
    if ds.n_work:
        psums, seg_of = _psums(a_data, b_data, ds)
        acc = torch.zeros((ds.n_seg, bm, bn), dtype=torch.float32,
                          device=a_data.device).index_add_(0, seg_of, psums)
        keep = (ds.seg_ci >= 0) & (ds.seg_ci < mb)   # pad runs dropped
        c[ds.seg_ci[keep].long(), ds.seg_cj[keep].long()] = acc[keep]
    return _crop(c, out_shape)


def stream_panel_spmm_plain(a_data: torch.Tensor, b_data: torch.Tensor,
                            ds: DeviceSchedule, *,
                            out_grid: Tuple[int, int],
                            out_shape: Tuple[int, int],
                            b_coords: BlockCoords = None) -> torch.Tensor:
    """K2 in plain PyTorch: merge each psum into its segment's row panel at
    column block ``cj``, then place the panels at their block rows.
    ``b_coords`` as in :func:`stream_spmm_plain`."""
    b_data = _b_blocks(b_data, b_coords)
    mb, nb = out_grid
    bm, bn = a_data.shape[1], b_data.shape[2]
    c = torch.zeros((mb, nb, bm, bn), dtype=torch.float32,
                    device=a_data.device)
    if ds.n_work:
        psums, seg_of = _psums(a_data, b_data, ds)
        flat = seg_of * nb + ds.cj.long()
        panels = torch.zeros((ds.n_seg * nb, bm, bn), dtype=torch.float32,
                             device=a_data.device).index_add_(0, flat, psums)
        panels = panels.reshape(ds.n_seg, nb, bm, bn)
        keep = (ds.seg_ci >= 0) & (ds.seg_ci < mb)   # pad runs dropped
        c[ds.seg_ci[keep].long()] = panels[keep]
    return _crop(c, out_shape)


# -- kernel launches ----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.library("stream_spmm")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # K1 and K2 take the same arguments: a walk and its chunk table
        for fn in (lib.flexagon_stream_spmm, lib.flexagon_stream_panel_spmm):
            fn.argtypes = [p] * 12 + [i] * 3 + [i] * 4 + [p, i, i] \
                + [p, p, i, i, p]
            fn.restype = i
        lib.flexagon_cuda_error_string.argtypes = [i]
        lib.flexagon_cuda_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _b_shape(b_data, b_coords):
    """(slots, bk, bn) of B in either form."""
    if b_coords is None:
        return tuple(b_data.shape)
    return (b_coords.nnzb, *b_coords.block_shape)


def _check(name, a_data, b_data, ds: DeviceSchedule, out_grid, out_shape,
           b_coords=None):
    """Everything the kernel assumes, checked on the host before launch."""
    dev = a_data.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    for label, t in (("a_data", a_data), ("b_data", b_data)):
        if t.device != dev or ds.device != dev:
            raise ValueError(f"{name}: operands and schedule must share one "
                             f"device ({label} on {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be float32, got "
                             f"{t.dtype}")
    if a_data.dim() != 3 or not a_data.is_contiguous():
        raise ValueError(f"{name}: a_data must be a contiguous (nnzb, rows, "
                         f"cols) block stack, got {tuple(a_data.shape)}")
    if b_coords is None:
        if b_data.dim() != 3 or not b_data.is_contiguous():
            raise ValueError(f"{name}: b_data must be a contiguous (nnzb, "
                             f"rows, cols) block stack, got "
                             f"{tuple(b_data.shape)}")
    elif (tuple(b_data.shape) != b_coords.shape or b_data.stride(1) != 1
          or b_coords.rows.device != dev
          or not 0 < b_data.stride(0) < 2 ** 31):
        raise ValueError(f"{name}: a B read in place must be the planned "
                         f"{b_coords.shape} operand with unit column stride "
                         f"on {dev}, got {tuple(b_data.shape)} strides "
                         f"{b_data.stride()} on {b_data.device}")
    n_b, bk, bn = _b_shape(b_data, b_coords)
    if a_data.shape[2] != bk:
        raise ValueError(f"{name}: block depths disagree, A blocks "
                         f"{tuple(a_data.shape[1:])}, B blocks {(bk, bn)}")
    if ds.max_a_slot >= a_data.shape[0] or ds.max_b_slot >= n_b:
        raise ValueError(f"{name}: schedule slots exceed the block stacks")
    mb, nb = out_grid
    bm = a_data.shape[1]
    m, n = out_shape
    if m > mb * bm or n > nb * bn or ds.max_cj >= nb or (
            b_coords is not None and n != b_coords.shape[1]):
        raise ValueError(f"{name}: output {out_shape} / grid {out_grid} "
                         f"disagree with the blocks or the schedule")


def _launch(entry: str, a_data, b_data, ds: DeviceSchedule, out_grid,
            out_shape, out_dtype, pointers, dims,
            b_coords=None) -> torch.Tensor:
    """Check, zero C, and launch one C entry of ``csrc/stream_spmm.cu``
    over ``pointers`` (the walk's arrays and its workspace) and the ints
    ``dims``; with ``b_coords``, ``b_data`` is the dense B, read in place.

    The caller counts the launch."""
    lib = _lib()
    name = entry.removeprefix("flexagon_")
    _check(name, a_data, b_data, ds, out_grid, out_shape, b_coords)
    c = torch.zeros(tuple(out_shape), dtype=torch.float32,
                    device=a_data.device)
    _, bk, bn = _b_shape(b_data, b_coords)
    bm = a_data.shape[1]
    stream = torch.cuda.current_stream(a_data.device).cuda_stream
    ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in (a_data, b_data, *pointers)]
    if b_coords is None:
        in_place = (None, None, 0, 0)
    else:
        in_place = (b_coords.rows.data_ptr(), b_coords.cols.data_ptr(),
                    b_data.shape[0], b_data.stride(0))
    err = getattr(lib, entry)(
        *ptrs, *dims, bm, bk, bn, out_grid[0],
        ctypes.c_void_p(c.data_ptr()), out_shape[0], out_shape[1],
        *in_place, ctypes.c_void_p(stream))
    if err:
        msg = lib.flexagon_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    return c.to(out_dtype)


def stream_spmm(a_data: torch.Tensor, b_data: torch.Tensor,
                ds: DeviceSchedule, *, out_grid: Tuple[int, int],
                out_shape: Tuple[int, int],
                out_dtype=torch.float32,
                b_coords: BlockCoords = None) -> torch.Tensor:
    """Run a destination-major schedule through the block-run kernel (K1).

    ``a_data``/``b_data`` are the compressed operands' block stacks
    (``(nnzb, bm, bk)`` / ``(nnzb, bk, bn)``); with ``b_coords``,
    ``b_data`` is instead the dense ``(K, N)`` fp32 B with unit column
    stride, read in place.  ``ds`` is the :class:`DeviceSchedule` on the
    operands' device.  Returns the dense ``out_shape`` product.  An empty
    schedule returns zeros and launches nothing.  On the card, the chunks
    of split segments write partial tiles to a workspace that the kernel's
    second pass sums in chunk order; both passes are one launch.
    """
    if a_data.device.type == "cpu":
        out = stream_spmm_plain(a_data, b_data, ds, out_grid=out_grid,
                                out_shape=out_shape, b_coords=b_coords)
        return out.to(out_dtype)
    if ds.n_work == 0:
        return torch.zeros(tuple(out_shape), dtype=out_dtype,
                           device=a_data.device)
    bm, bn = a_data.shape[1], _b_shape(b_data, b_coords)[2]
    part = (torch.empty((ds.n_slots, bm, bn), dtype=torch.float32,
                        device=a_data.device) if ds.n_split else None)
    out = _launch("flexagon_stream_spmm", a_data, b_data, ds, out_grid,
                  out_shape, out_dtype,
                  (ds.a_slot, ds.b_slot, ds.chunk_start, ds.chunk_seg,
                   ds.chunk_slot, ds.seg_ci, ds.seg_cj, ds.split_seg,
                   ds.split_start, part),
                  (ds.n_chunk, ds.n_split, dest_rows(bm, out_shape[0])),
                  b_coords)
    stream_spmm.launches += 1
    return out


stream_spmm.launches = 0


def stream_panel_spmm(a_data: torch.Tensor, b_data: torch.Tensor,
                      ds: DeviceSchedule, *, out_grid: Tuple[int, int],
                      out_shape: Tuple[int, int],
                      out_dtype=torch.float32,
                      b_coords: BlockCoords = None) -> torch.Tensor:
    """Run a row-major schedule through the row-panel kernel (K2).

    Arguments as :func:`stream_spmm`; ``ds`` is a panel schedule.  Each
    run is one output block row.  On the card K2 walks the schedule's
    :class:`ColumnTable`: one CUDA block per chunk of a column segment and
    sub-tile of its ``(bm, bn)`` tile, the chunks of split column segments
    summed in chunk order by a second pass of the same launch.  Tiles that
    no entry touches stay zero; a schedule with no real entry launches
    nothing.
    """
    if a_data.device.type == "cpu":
        out = stream_panel_spmm_plain(a_data, b_data, ds, out_grid=out_grid,
                                      out_shape=out_shape, b_coords=b_coords)
        return out.to(out_dtype)
    cols = ds.cols
    if cols is None:
        raise ValueError(f"stream_panel_spmm: a {ds.kind!r} schedule has no "
                         "column table; K2 takes panel schedules")
    if cols.n_chunk == 0:
        return torch.zeros(tuple(out_shape), dtype=out_dtype,
                           device=a_data.device)
    bm, bn = a_data.shape[1], _b_shape(b_data, b_coords)[2]
    part = (torch.empty((cols.n_slots, bm, bn), dtype=torch.float32,
                        device=a_data.device) if cols.n_split else None)
    out = _launch("flexagon_stream_panel_spmm", a_data, b_data, ds, out_grid,
                  out_shape, out_dtype,
                  (cols.a_slot, cols.b_slot, cols.chunk_start,
                   cols.chunk_seg, cols.chunk_slot, cols.col_ci, cols.col_cj,
                   cols.split_seg, cols.split_start, part),
                  (cols.n_chunk, cols.n_split, dest_rows(bm, out_shape[0])),
                  b_coords)
    stream_panel_spmm.launches += 1
    return out


stream_panel_spmm.launches = 0
