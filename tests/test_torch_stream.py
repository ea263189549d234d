"""The port's stream kernels, plain versions on the CPU, against the JAX
Pallas kernels in interpret mode.

K1 (``stream_spmm``, IP and OP schedules) and K2 (``stream_panel_spmm``,
Gustavson schedules) at blocks 8, 16 and 32 with ragged edges, on plain,
``pad_schedule``-padded and empty schedules; B as a block stack and as
the dense operand read in place (``b_coords``), bit for bit the same.  Tolerance ``rtol=atol=1e-4``
as in ``tests/test_stream_kernels.py``: both sides sum in fp32, in
different orders.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import dataflows as jdf
from repro.core import formats as jfm
from repro import kernels as jkernels
from repro.kernels import stream as jks

from repro_torch.core import dataflows as tdf
from repro_torch.core import formats as tfm
from repro_torch import kernels as tkernels
from repro_torch.kernels import ip_spmm
from repro_torch.kernels import stream as tks

TOL = dict(rtol=1e-4, atol=1e-4)

FAMILIES = {
    # family: (A format, B format, builder, schedule kind)
    "ip": ("bcsr", "bcsc", "build_ip_plan", None),
    "op": ("bcsc", "bcsr", "build_op_plan", True),
    "gust": ("bcsr", "bcsr", "build_gust_plan", False),
}


def _case(block, seed):
    rng = np.random.default_rng(seed)
    m, k, n = 2 * block + 3, 3 * block + 1, 2 * block + 5
    a = jfm.random_sparse_dense(rng, (m, k), density=0.6,
                                block_shape=(block, block))
    b = jfm.random_sparse_dense(rng, (k, n), density=0.6,
                                block_shape=(block, block))
    return a, b


def _schedules(family, a, b, block):
    """(jax operands, torch operands, jax schedule, torch schedule)."""
    fa, fb, builder, by_dest = FAMILIES[family]
    bs = (block, block)
    ja = getattr(jfm, f"dense_to_{fa}")(a, bs)
    jb = getattr(jfm, f"dense_to_{fb}")(b, bs)
    ta = getattr(tfm, f"dense_to_{fa}")(a, bs, device="cpu")
    tb = getattr(tfm, f"dense_to_{fb}")(b, bs, device="cpu")
    jp = getattr(jdf, builder)(ja, jb)
    tp = getattr(tdf, builder)(ta, tb)
    if by_dest is None:
        return ja, jb, ta, tb, jks.schedule_from_ip(jp), \
            tks.schedule_from_ip(tp)
    return ja, jb, ta, tb, jks.schedule_from_stream(jp, by_dest=by_dest), \
        tks.schedule_from_stream(tp, by_dest=by_dest)


def _b_coords(tb):
    """The block coordinates of each slot of the torch block operand
    ``tb`` (BlockCSR: fibers are block rows; BlockCSC: block columns)."""
    fibers = np.repeat(np.arange(tb.indptr.size - 1), np.diff(tb.indptr))
    rows, cols = ((fibers, tb.indices) if isinstance(tb, tfm.BlockCSR)
                  else (tb.indices, fibers))
    return tks.block_coords(rows, cols, tb.shape, tb.block_shape, "cpu")


def _run_both(family, ja, jb, ta, tb, js, ts):
    grid = (ja.grid[0], jb.grid[1])
    shape = (ja.shape[0], jb.shape[1])
    jfn = jks.stream_panel_spmm if family == "gust" else jks.stream_spmm
    tfn = tks.stream_panel_spmm if family == "gust" else tks.stream_spmm
    want = np.asarray(jfn(ja.data, jb.data, js, out_grid=grid,
                          out_shape=shape, interpret=True))
    got = tfn(ta.data, tb.data, tks.device_schedule(ts, "cpu"), out_grid=grid,
              out_shape=shape)
    return got, want


@pytest.mark.parametrize("variant", ["plain", "padded", "empty"])
@pytest.mark.parametrize("family", ["ip", "op", "gust"])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_plain_kernels_match_pallas(block, family, variant):
    a, b = _case(block, seed=block)
    ja, jb, ta, tb, js, ts = _schedules(family, a, b, block)
    if variant == "padded":
        oob = ja.grid[0]
        js = jks.pad_schedule(js, js.n_work + 5, js.n_runs + 3, oob)
        ts = tks.pad_schedule(ts, ts.n_work + 5, ts.n_runs + 3, oob)
    elif variant == "empty":
        js, ts = jks._empty_schedule(js.kind), tks._empty_schedule(ts.kind)
    before = (tks.stream_spmm.launches, tks.stream_panel_spmm.launches)
    got, want = _run_both(family, ja, jb, ta, tb, js, ts)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if variant == "empty":
        assert not got.any()
    else:
        np.testing.assert_allclose(got.numpy(), a @ b, **TOL)
    # the CPU path runs the plain version: no kernel launch is counted
    assert (tks.stream_spmm.launches,
            tks.stream_panel_spmm.launches) == before


@pytest.mark.parametrize("family", ["ip", "op", "gust"])
def test_device_schedule_segments(family):
    """One segment per run, destinations from run_ci/run_cj, pads apart."""
    a, b = _case(8, seed=1)
    *_, ts = _schedules(family, a, b, 8)
    ds = tks.device_schedule(ts, "cpu")
    assert ds.n_seg == ts.n_runs and ds.n_work == ts.n_work
    starts = ds.seg_start.numpy()
    assert starts[0] == 0 and starts[-1] == ts.n_work
    np.testing.assert_array_equal(starts[:-1], np.flatnonzero(ts.is_first))
    np.testing.assert_array_equal(ds.seg_ci.numpy(), ts.run_ci)
    padded = tks.pad_schedule(ts, ts.n_work + 4, ts.n_runs + 2, 99)
    dp = tks.device_schedule(padded, "cpu")
    # every pad entry is a segment of its own, aimed at the dropped row
    assert dp.n_seg == ts.n_runs + 4
    assert (dp.seg_ci.numpy()[ts.n_runs:] == 99).all()


def test_out_dtype_and_schedule_forms_agree():
    """A host schedule (uploaded by the one-shot wrapper) and a device
    schedule give the same product."""
    a, b = _case(16, seed=2)
    _, _, ta, tb, _, ts = _schedules("ip", a, b, 16)
    ds = tks.device_schedule(ts, "cpu")
    kw = dict(out_grid=(ta.grid[0], tb.grid[1]),
              out_shape=(ta.shape[0], tb.shape[1]))
    host = ip_spmm(ta, tb, schedule=ts)
    dev = tks.stream_spmm(ta.data, tb.data, ds, **kw)
    torch.testing.assert_close(host, dev, rtol=0, atol=0)
    wide = tks.stream_spmm(ta.data, tb.data, ds, out_dtype=torch.float64,
                           **kw)
    assert wide.dtype == torch.float64


@pytest.mark.parametrize("family", ["ip", "op", "gust"])
@pytest.mark.parametrize("block", [8, 16])
def test_one_shot_wrappers_match_pallas(block, family):
    """``ip_spmm``/``op_spmm``/``gust_spmm`` with no plan or schedule build
    both on the host, as the JAX wrappers do, and agree with them."""
    a, b = _case(block, seed=10 + block)
    ja, jb, ta, tb, _, _ = _schedules(family, a, b, block)
    fn = {"ip": "ip_spmm", "op": "op_spmm", "gust": "gust_spmm"}[family]
    want = np.asarray(getattr(jkernels, fn)(ja, jb, interpret=True))
    got = getattr(tkernels, fn)(ta, tb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_malformed_schedule_rejected():
    a, b = _case(8, seed=3)
    *_, ts = _schedules("op", a, b, 8)
    ts.is_first = ts.is_first.copy()
    ts.is_first[0] = 0
    with pytest.raises(ValueError, match="does not start a run"):
        tks.device_schedule(ts, "cpu")


# -- K1's chunk table and second pass -----------------------------------------


def _variant_schedules(family, block, variant):
    a, b = _case(block, seed=block + 20)
    ja, jb, ta, tb, js, ts = _schedules(family, a, b, block)
    if variant == "padded":
        oob = ja.grid[0]
        js = jks.pad_schedule(js, js.n_work + 5, js.n_runs + 3, oob)
        ts = tks.pad_schedule(ts, ts.n_work + 5, ts.n_runs + 3, oob)
    elif variant == "empty":
        js, ts = jks._empty_schedule(js.kind), tks._empty_schedule(ts.kind)
    return a, b, ja, jb, ta, tb, js, ts


@pytest.mark.parametrize("chunk", [1, 2, 3, None])
@pytest.mark.parametrize("variant", ["plain", "padded", "empty"])
@pytest.mark.parametrize("family", ["ip", "op", "gust"])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_chunk_table_partitions_every_segment(block, family, variant, chunk):
    """Chunks cover the work list once, in order, each inside one segment
    and at most ``chunk`` long; a segment of several chunks owns
    consecutive workspace slots in chunk order, one of one chunk none."""
    *_, ts = _variant_schedules(family, block, variant)
    ds = tks.device_schedule(ts, "cpu", chunk=chunk)
    size = tks.chunk_size(ts.n_work) if chunk is None else chunk
    assert ds.chunk == size
    seg_start = ds.seg_start.numpy()
    start = ds.chunk_start.numpy()
    seg = ds.chunk_seg.numpy()
    slot = ds.chunk_slot.numpy()
    split_seg, split_start = ds.split_seg.numpy(), ds.split_start.numpy()
    assert start[0] == 0 and start[-1] == ts.n_work
    assert (np.diff(start) >= 1).all() and (np.diff(start) <= size).all()
    assert (np.diff(seg) >= 0).all()
    # each chunk lies inside its segment, and the chunks of a segment
    # tile exactly its entries
    assert (start[:-1] >= seg_start[seg]).all()
    assert (start[1:] <= seg_start[seg + 1]).all()
    covered = np.zeros(ts.n_work, int)
    for lo, hi in zip(start[:-1], start[1:]):
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert sorted(set(seg.tolist())) == list(range(ds.n_seg))
    pieces = np.bincount(seg, minlength=ds.n_seg)
    np.testing.assert_array_equal(split_seg, np.flatnonzero(pieces > 1))
    assert ds.n_split == split_seg.size
    assert ds.n_slots == split_start[-1] == int((slot >= 0).sum())
    np.testing.assert_array_equal(slot[slot >= 0],
                                  np.arange(ds.n_slots))
    for p, s in enumerate(split_seg):
        np.testing.assert_array_equal(
            slot[seg == s], np.arange(split_start[p], split_start[p + 1]))
    assert (slot[pieces[seg] == 1] == -1).all()


def _in_place_blocks(b, coords, ldb):
    """The kernels' in-place addressing of a dense B, in numpy: ``b`` laid
    out in one flat buffer with rows ``ldb`` floats apart; B slot ``s`` is
    the block that starts at ``rows[s]·bk·ldb + cols[s]·bn``, its rows past
    K and columns past N loaded as zeros.  Returns slot -> (bk, bn) block."""
    (k, n), (bk, bn) = coords.shape, coords.block_shape
    flat = np.full(k * ldb, np.nan, np.float32)      # the gaps are never read
    flat.reshape(k, ldb)[:, :n] = b
    rows, cols = coords.rows.numpy(), coords.cols.numpy()

    def block(s):
        r0, c0 = int(rows[s]) * bk, int(cols[s]) * bn
        out = np.zeros((bk, bn), np.float32)
        for r in range(min(bk, k - r0)):
            at = (r0 + r) * ldb + c0
            out[r, :max(0, min(bn, n - c0))] = flat[at: at + min(bn, n - c0)]
        return out

    return block


def _walk_two_pass(a_data, b_data, walk, n_slots, out_grid, out_shape,
                   b_block=None):
    """A kernel's two passes in plain numpy over one walk, the tensors
    ``(a_slot, b_slot, chunk_start, chunk_seg, chunk_slot, split_seg,
    split_start, seg_ci, seg_cj)``: each chunk sums its entries in order; a
    segment of one chunk is its sum, a split one its chunks' workspace
    slots summed in chunk order; pad runs dropped.  ``b_block`` (slot ->
    block) reads B in place; by default B is the stack ``b_data``."""
    a, b = a_data.numpy(), b_data.numpy()
    b_block = b_block or b.__getitem__
    (a_slot, b_slot, start, seg, slot, split_seg, split_start, ci,
     cj) = (t.numpy() for t in walk)
    mb, nb = out_grid
    bm, bn = a.shape[1], b.shape[2]
    c = np.zeros((mb * bm, nb * bn), np.float32)
    work = np.zeros((max(n_slots, 1), bm, bn), np.float32)
    direct = {}
    for ch in range(seg.size):
        acc = np.zeros((bm, bn), np.float32)
        for w in range(start[ch], start[ch + 1]):
            acc += a[a_slot[w]] @ b_block(b_slot[w])
        if slot[ch] < 0:
            direct[seg[ch]] = acc
        else:
            work[slot[ch]] = acc
    tiles = dict(direct)
    for p, s in enumerate(split_seg):
        acc = np.zeros((bm, bn), np.float32)
        for q in range(split_start[p], split_start[p + 1]):
            acc += work[q]
        tiles[s] = acc
    for s, tile in tiles.items():
        if 0 <= ci[s] < mb:
            c[ci[s] * bm:(ci[s] + 1) * bm, cj[s] * bn:(cj[s] + 1) * bn] = tile
    return c[: out_shape[0], : out_shape[1]]


def _two_pass(a_data, b_data, ds, out_grid, out_shape, b_block=None):
    """K1's two passes over the schedule's own segments."""
    return _walk_two_pass(
        a_data, b_data,
        (ds.a_slot, ds.b_slot, ds.chunk_start, ds.chunk_seg, ds.chunk_slot,
         ds.split_seg, ds.split_start, ds.seg_ci, ds.seg_cj),
        ds.n_slots, out_grid, out_shape, b_block)


@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("variant", ["plain", "padded", "empty"])
@pytest.mark.parametrize("family", ["ip", "op"])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_two_pass_emulation_matches_plain_and_pallas(block, family, variant,
                                                      chunk):
    """Chunk partials summed in chunk order equal ``stream_spmm_plain``
    and the Pallas kernel in interpret mode to 1e-5; the same walk with B
    read in place (rows wider than N, as in a view) gives the same bits."""
    a, b, ja, jb, ta, tb, js, ts = _variant_schedules(family, block, variant)
    ds = tks.device_schedule(ts, "cpu", chunk=chunk)
    if variant != "empty" and chunk == 1:
        assert ds.n_split > 0         # the second pass has work
    grid = (ja.grid[0], jb.grid[1])
    shape = (ja.shape[0], jb.shape[1])
    got = _two_pass(ta.data, tb.data, ds, grid, shape)
    in_place = _two_pass(ta.data, tb.data, ds, grid, shape,
                         _in_place_blocks(b, _b_coords(tb), b.shape[1] + 3))
    np.testing.assert_array_equal(in_place, got)
    plain = tks.stream_spmm_plain(ta.data, tb.data, ds, out_grid=grid,
                                  out_shape=shape)
    want = np.asarray(jks.stream_spmm(ja.data, jb.data, js, out_grid=grid,
                                      out_shape=shape, interpret=True))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bm,m,rows", [(8, 100, 16), (16, 4, 16),
                                       (128, 4, 16), (128, 20, 32),
                                       (32, 500, 32), (128, 128, 64),
                                       (64, 33, 64), (128, 1000, 64)])
def test_dest_rows_cover_the_valid_rows(bm, m, rows):
    assert tks.dest_rows(bm, m) == rows
    assert rows >= min(bm, m, 64)


def test_chunk_size_follows_the_work_list():
    assert tks.chunk_size(0) == tks.MIN_CHUNK
    # the 4-token FFN down projection: 12 runs of 35 entries -> 9 chunks each
    assert tks.chunk_size(12 * 35) == 4
    seg_start = np.arange(13) * 35
    _, seg, slot, split_seg, split_start = tks.chunk_table(seg_start, 4)
    assert seg.size == 12 * 9 and split_seg.size == 12
    assert split_start[-1] == 108 and (slot >= 0).all()
    # many short runs split nothing
    w = 3000
    assert tks.chunk_size(w) == -(-w // tks.TARGET_CHUNKS)
    _, _, slot, split_seg, _ = tks.chunk_table(np.arange(1001) * 3,
                                               tks.chunk_size(w))
    assert split_seg.size == 0 and (slot == -1).all()
    with pytest.raises(ValueError, match="chunk"):
        tks.device_schedule(tks._empty_schedule(), "cpu", chunk=0)


# -- K2's column table and its two passes -------------------------------------


@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("variant", ["plain", "padded", "empty"])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_column_table_partitions_every_run(block, variant, chunk):
    """Each real run's entries land in its column segments exactly once, in
    work-list order within a segment; pad runs have none; one column
    segment per touched tile; the chunk table cuts the column segments as
    K1's cuts its segments."""
    a, b, ja, jb, ta, tb, js, ts = _variant_schedules("gust", block, variant)
    ds = tks.device_schedule(ts, "cpu", chunk=chunk)
    cols = ds.cols
    size = tks.chunk_size(ts.n_work) if chunk is None else chunk
    assert ds.chunk == size
    mb = ja.grid[0]
    seg_start, seg_ci = ds.seg_start.numpy(), ds.seg_ci.numpy()
    seg_of = np.repeat(np.arange(ds.n_seg), np.diff(seg_start))
    real = np.flatnonzero((seg_ci[seg_of] >= 0) & (seg_ci[seg_of] < mb))
    assert real.size == ts.n_real_work           # pads are the tail
    cj = ds.cj.numpy()
    keep = (seg_ci >= 0) & (seg_ci < mb)
    order, col_start, col_ci, col_cj = tks.column_table(seg_start, seg_ci,
                                                        cj, keep)
    np.testing.assert_array_equal(cols.col_start.numpy(), col_start)
    np.testing.assert_array_equal(cols.col_ci.numpy(), col_ci)
    np.testing.assert_array_equal(cols.col_cj.numpy(), col_cj)
    np.testing.assert_array_equal(np.sort(order), real)
    np.testing.assert_array_equal(cols.a_slot.numpy(),
                                  ds.a_slot.numpy()[order])
    np.testing.assert_array_equal(cols.b_slot.numpy(),
                                  ds.b_slot.numpy()[order])
    assert col_start[0] == 0 and col_start[-1] == order.size
    assert (np.diff(col_start) >= 1).all()
    tiles = set()
    for g, (lo, hi) in enumerate(zip(col_start[:-1], col_start[1:])):
        entries = order[lo:hi]
        assert (np.diff(entries) > 0).all()      # work-list order
        assert (seg_of[entries] == seg_of[entries[0]]).all()
        assert (cj[entries] == col_cj[g]).all()
        assert col_ci[g] == seg_ci[seg_of[entries[0]]]
        assert 0 <= col_ci[g] < mb
        tiles.add((int(col_ci[g]), int(col_cj[g])))
    assert len(tiles) == cols.n_seg              # one segment per tile
    start, seg = cols.chunk_start.numpy(), cols.chunk_seg.numpy()
    slot = cols.chunk_slot.numpy()
    assert start[0] == 0 and start[-1] == order.size
    assert (np.diff(start) >= 1).all() and (np.diff(start) <= size).all()
    assert (start[:-1] >= col_start[seg]).all()
    assert (start[1:] <= col_start[seg + 1]).all()
    assert sorted(set(seg.tolist())) == list(range(cols.n_seg))
    pieces = np.bincount(seg, minlength=cols.n_seg)
    np.testing.assert_array_equal(cols.split_seg.numpy(),
                                  np.flatnonzero(pieces > 1))
    split_start = cols.split_start.numpy()
    assert cols.n_slots == split_start[-1] == int((slot >= 0).sum())
    for p, s in enumerate(cols.split_seg.numpy()):
        np.testing.assert_array_equal(
            slot[seg == s], np.arange(split_start[p], split_start[p + 1]))
    assert (slot[pieces[seg] == 1] == -1).all()


def _panel_two_pass(a_data, b_data, ds, out_grid, out_shape, b_block=None):
    """K2's two passes over the column table."""
    c = ds.cols
    return _walk_two_pass(
        a_data, b_data,
        (c.a_slot, c.b_slot, c.chunk_start, c.chunk_seg, c.chunk_slot,
         c.split_seg, c.split_start, c.col_ci, c.col_cj),
        c.n_slots, out_grid, out_shape, b_block)


@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("variant", ["plain", "padded", "empty"])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_panel_two_pass_emulation_matches_plain_and_pallas(block, variant,
                                                           chunk):
    """K2's walk of the column table, chunk partials summed in chunk
    order, equals ``stream_panel_spmm_plain`` and the Pallas kernel in
    interpret mode to 1e-5; with B read in place, the same bits."""
    a, b, ja, jb, ta, tb, js, ts = _variant_schedules("gust", block, variant)
    ds = tks.device_schedule(ts, "cpu", chunk=chunk)
    if variant != "empty" and chunk == 1:
        assert ds.cols.n_split > 0    # the second pass has work
    grid = (ja.grid[0], jb.grid[1])
    shape = (ja.shape[0], jb.shape[1])
    got = _panel_two_pass(ta.data, tb.data, ds, grid, shape)
    in_place = _panel_two_pass(ta.data, tb.data, ds, grid, shape,
                               _in_place_blocks(b, _b_coords(tb),
                                                b.shape[1] + 3))
    np.testing.assert_array_equal(in_place, got)
    plain = tks.stream_panel_spmm_plain(ta.data, tb.data, ds, out_grid=grid,
                                        out_shape=shape)
    want = np.asarray(jks.stream_panel_spmm(ja.data, jb.data, js,
                                            out_grid=grid, out_shape=shape,
                                            interpret=True))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_column_table_long_columns():
    """Few runs with long per-column chains (the shape of ``chip_smoke.py``'s
    K2 long-column sweep, at block 8): the default chunking splits each
    column segment; a chunk as long as the work list splits none."""
    rng = np.random.default_rng(7)
    m, k, n, blk = 4, 40 * 8, 2 * 8, 8
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ta = tfm.dense_to_bcsr(a, (blk, blk), device="cpu")
    tb = tfm.dense_to_bcsr(b, (blk, blk), device="cpu")
    ts = tks.schedule_from_stream(tdf.build_gust_plan(ta, tb), by_dest=False)
    assert ts.n_runs == 1 and ts.n_work == 80
    kw = dict(out_grid=(1, 2), out_shape=(m, n))
    for chunk, split in ((None, True), (ts.n_work, False)):
        ds = tks.device_schedule(ts, "cpu", chunk=chunk)
        assert ds.cols.n_seg == 2 and (ds.cols.n_split == 2) == split
        assert ds.cols.n_chunk == (2 * 40 // tks.MIN_CHUNK if split else 2)
        got = _panel_two_pass(ta.data, tb.data, ds, **kw)
        np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)


def test_dest_schedule_has_no_column_table():
    a, b = _case(8, seed=4)
    for family in ("ip", "op"):
        *_, ts = _schedules(family, a, b, 8)
        assert tks.device_schedule(ts, "cpu").cols is None


# -- B read in place -----------------------------------------------------------


def _torch_schedule(family, a, b, block, variant):
    """Torch operands and a device schedule alone (no JAX), as
    ``_variant_schedules`` makes them."""
    fa, fb, builder, by_dest = FAMILIES[family]
    bs = (block, block)
    ta = getattr(tfm, f"dense_to_{fa}")(a, bs, device="cpu")
    tb = getattr(tfm, f"dense_to_{fb}")(b, bs, device="cpu")
    tp = getattr(tdf, builder)(ta, tb)
    ts = (tks.schedule_from_ip(tp) if by_dest is None
          else tks.schedule_from_stream(tp, by_dest=by_dest))
    if variant == "padded":
        ts = tks.pad_schedule(ts, ts.n_work + 5, ts.n_runs + 3, ta.grid[0])
    elif variant == "empty":
        ts = tks._empty_schedule(ts.kind)
    return ta, tb, tks.device_schedule(ts, "cpu", chunk=2)


@pytest.mark.parametrize("layout", ["contiguous", "row_view"])
@pytest.mark.parametrize("variant", ["plain", "padded", "empty"])
@pytest.mark.parametrize("family", ["ip", "op", "gust"])
@pytest.mark.parametrize("m,k,n,block", [(37, 147, 70, 32),   # R0's K
                                         (21, 147, 45, 16),
                                         (19, 25, 21, 8)])
def test_plain_kernels_read_dense_b_in_place(m, k, n, block, family,
                                             variant, layout):
    """K1's and K2's plain forms on the dense B with ``b_coords`` give the
    stack form's bits: ragged K (147) and N, every schedule family, a
    contiguous B and a view whose rows are wider than N."""
    rng = np.random.default_rng(m + k + n + block)
    a = jfm.random_sparse_dense(rng, (m, k), density=0.6,
                                block_shape=(block, block))
    b = jfm.random_sparse_dense(rng, (k, n), density=0.6,
                                block_shape=(block, block))
    ta, tb, ds = _torch_schedule(family, a, b, block, variant)
    dense = torch.as_tensor(b)
    if layout == "row_view":
        wide = torch.full((k, n + 5), float("nan"))
        wide[:, 2:n + 2] = dense
        dense = wide[:, 2:n + 2]
        assert dense.stride() == (n + 5, 1)
    kw = dict(out_grid=(ta.grid[0], tb.grid[1]), out_shape=(m, n))
    fn = tks.stream_panel_spmm if family == "gust" else tks.stream_spmm
    stack = fn(ta.data, tb.data, ds, **kw)
    got = fn(ta.data, dense, ds, b_coords=_b_coords(tb), **kw)
    assert torch.equal(got, stack)
    if variant != "empty":
        np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_block_coords_reject_slots_off_the_grid():
    with pytest.raises(ValueError, match="outside"):
        tks.block_coords(np.array([0, 5]), np.array([0, 0]), (147, 40),
                         (32, 32), "cpu")
