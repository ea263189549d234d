"""Phase-1 parity: the port's numpy artifacts are byte-equal to the JAX
package's on the same numpy-seeded inputs.

Covers block and scalar formats, the index-plan builders, the
``StreamSchedule`` lowering (padded too), every artifact a pinned
``flexagon_plan`` builds, and the selector's choice on the paper's Table 6
layers when the port's ``DeviceSpec`` carries the JAX ``TPUSpec`` numbers.
"""
import dataclasses

import numpy as np
import pytest

from repro import flexagon_plan as jax_flexagon_plan
from repro.core import dataflows as jdf
from repro.core import formats as jfm
from repro.core import selector as jsel
from repro.core import workloads as jwl
from repro.kernels import stream as jks

from repro_torch import flexagon_plan
from repro_torch.core import dataflows as tdf
from repro_torch.core import formats as tfm
from repro_torch.core import selector as tsel
from repro_torch.core import workloads as twl
from repro_torch.kernels import stream as tks


DATAFLOWS = tdf.DATAFLOWS
SCHEDULE_FIELDS = ("a_slot", "b_slot", "cj", "is_first", "is_last", "run_id",
                   "run_ci", "run_cj", "real_w", "real_r", "oob")


def _same(x, y):
    """Byte-equal: same dtype, same shape, same bytes."""
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    assert x.shape == y.shape, (x.shape, y.shape)
    assert x.tobytes() == y.tobytes()


def _case(seed=0, m=40, k=56, n=48, da=0.45, db=0.55, block=(8, 8, 8)):
    rng = np.random.default_rng(seed)
    a = jfm.random_sparse_dense(rng, (m, k), density=da,
                                block_shape=block[:2])
    b = jfm.random_sparse_dense(rng, (k, n), density=db,
                                block_shape=block[1:])
    return a, b


def _same_block_format(jx, tx):
    _same(jx.data, tx.data.numpy())
    _same(jx.indptr, tx.indptr)
    _same(jx.indices, tx.indices)
    assert tuple(jx.shape) == tuple(tx.shape)
    assert tuple(jx.block_shape) == tuple(tx.block_shape)


def _same_schedule(js, ts):
    for f in SCHEDULE_FIELDS:
        _same(getattr(js, f), getattr(ts, f))
    assert js.n_runs == ts.n_runs and js.kind == ts.kind
    assert js.describe() == ts.describe()


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [(8, 8), (16, 8), (8, 16), (5, 7)])
@pytest.mark.parametrize("fmt", ["bcsr", "bcsc"])
def test_block_formats_byte_equal(block, fmt):
    rng = np.random.default_rng(1)
    x = jfm.random_sparse_dense(rng, (37, 45), density=0.5, block_shape=block)
    jx = getattr(jfm, f"dense_to_{fmt}")(x, block)
    tx = getattr(tfm, f"dense_to_{fmt}")(x, block, device="cpu")
    _same_block_format(jx, tx)
    _same(jx.bitmap(), tx.bitmap())
    _same(jfm.block_occupancy(x, block), tfm.block_occupancy(x, block))
    np.testing.assert_array_equal(np.asarray(jx.todense()),
                                  tx.todense().numpy())


@pytest.mark.parametrize("block", [None, (8, 8), (4, 16)])
def test_random_sparse_dense_same_draws(block):
    kw = dict(density=0.3, block_shape=block)
    _same(jfm.random_sparse_dense(np.random.default_rng(5), (33, 29), **kw),
          tfm.random_sparse_dense(np.random.default_rng(5), (33, 29), **kw))


@pytest.mark.parametrize("cls", ["CSR", "CSC"])
def test_scalar_formats_byte_equal(cls):
    x = jfm.random_sparse_dense(np.random.default_rng(2), (17, 23),
                                density=0.3)
    jx = getattr(jfm, cls).from_dense(x)
    tx = getattr(tfm, cls).from_dense(x)
    for f in ("data", "indptr", "indices"):
        _same(getattr(jx, f), getattr(tx, f))
    _same(jx.todense(), tx.todense())


# ---------------------------------------------------------------------------
# Index plans and schedules
# ---------------------------------------------------------------------------


def _operand_pairs(a, b, bs=(8, 8)):
    """(jax, torch) operands in every format the builders take."""
    out = {}
    for name, x in (("a", a), ("b", b)):
        for fmt in ("bcsr", "bcsc"):
            out[name + fmt] = (getattr(jfm, f"dense_to_{fmt}")(x, bs),
                               getattr(tfm, f"dense_to_{fmt}")(
                                   x, bs, device="cpu"))
    return out


BUILDERS = {
    "ip": ("build_ip_plan", "abcsr", "bbcsc"),
    "op": ("build_op_plan", "abcsc", "bbcsr"),
    "gust": ("build_gust_plan", "abcsr", "bbcsr"),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", ["ip", "op", "gust"])
def test_index_plans_and_schedules_byte_equal(family, seed):
    a, b = _case(seed=seed)
    ops = _operand_pairs(a, b)
    builder, ka, kb = BUILDERS[family]
    jp = getattr(jdf, builder)(ops[ka][0], ops[kb][0])
    tp = getattr(tdf, builder)(ops[ka][1], ops[kb][1])
    if family == "ip":
        for f in ("pair_a", "pair_b", "npairs"):
            _same(getattr(jp, f), getattr(tp, f))
        assert jp.max_pairs == tp.max_pairs
        js, ts = jks.schedule_from_ip(jp), tks.schedule_from_ip(tp)
    else:
        for f in ("a_slot", "b_slot", "ci", "cj", "seg_ptr"):
            _same(getattr(jp, f), getattr(tp, f))
        assert jp.order == tp.order
        by_dest = family == "op"
        js = jks.schedule_from_stream(jp, by_dest=by_dest)
        ts = tks.schedule_from_stream(tp, by_dest=by_dest)
    _same_schedule(js, ts)
    # the padding every stacking seam applies
    oob = ops["abcsr"][1].grid[0]
    _same_schedule(jks.pad_schedule(js, js.n_work + 4, js.n_runs + 3, oob),
                   tks.pad_schedule(ts, ts.n_work + 4, ts.n_runs + 3, oob))


def test_empty_schedules_byte_equal():
    a, b = _case(seed=3, da=0.0)
    ops = _operand_pairs(a, b)
    _same_schedule(
        jks.schedule_from_ip(jdf.build_ip_plan(ops["abcsr"][0],
                                               ops["bbcsc"][0])),
        tks.schedule_from_ip(tdf.build_ip_plan(ops["abcsr"][1],
                                               ops["bbcsc"][1])))
    for by_dest in (True, False):
        _same_schedule(
            jks.schedule_from_stream(jdf.build_gust_plan(
                ops["abcsr"][0], ops["bbcsr"][0]), by_dest=by_dest),
            tks.schedule_from_stream(tdf.build_gust_plan(
                ops["abcsr"][1], ops["bbcsr"][1]), by_dest=by_dest))


@pytest.mark.parametrize("w_total,r_total,oob", [(3, 2, 9), (10, 0, 9)])
def test_pad_schedule_rejects_the_same_extents(w_total, r_total, oob):
    a, b = _case(seed=4)
    ops = _operand_pairs(a, b)
    js = jks.schedule_from_ip(jdf.build_ip_plan(ops["abcsr"][0],
                                                ops["bbcsc"][0]))
    ts = tks.schedule_from_ip(tdf.build_ip_plan(ops["abcsr"][1],
                                                ops["bbcsc"][1]))
    with pytest.raises(ValueError):
        jks.pad_schedule(js, w_total, r_total, oob)
    with pytest.raises(ValueError):
        tks.pad_schedule(ts, w_total, r_total, oob)


# ---------------------------------------------------------------------------
# Pinned flexagon_plan artifacts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_pinned_plan_artifacts_byte_equal(dataflow):
    a, b = _case(seed=5)
    bs = (8, 8, 8)
    jp = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                           backend="pallas")
    tp = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                       backend="cuda", device="cpu")
    assert jp.dataflow == tp.dataflow == dataflow
    assert jp.fingerprint == tp.fingerprint
    for jl, tl in ((jp.a_layout, tp.a_layout), (jp.b_layout, tp.b_layout)):
        for f in ("rows", "cols", "indptr"):
            _same(getattr(jl, f), getattr(tl, f))
        assert jl.fmt.value == tl.fmt.value
    for f in ("pair_a", "pair_b", "npairs", "a_slot", "b_slot", "ci", "cj",
              "seg_ptr"):
        if hasattr(jp.index_plan, f):
            _same(getattr(jp.index_plan, f), getattr(tp.index_plan, f))
    _same_schedule(jp.aux["stream_schedule"], tp.aux["stream_schedule"])
    assert ("dense" in jp.aux) == ("dense" in tp.aux)


@pytest.mark.parametrize("threshold", [0.25, 0.5, 2.0])
def test_dense_escape_marker_agrees(threshold):
    from repro.backends import get_backend as jax_get_backend
    from repro_torch import get_backend

    a, b = _case(seed=6, da=0.9, db=0.8)
    jbe, tbe = jax_get_backend("pallas"), get_backend("cuda")
    saved = (jbe.dense_threshold, tbe.dense_threshold)
    jbe.dense_threshold = tbe.dense_threshold = threshold
    try:
        for d in ("ip_m", "op_n", "gust_m"):
            jp = jax_flexagon_plan(a, b, dataflow=d, block_shape=(8, 8, 8),
                                   backend="pallas")
            tp = flexagon_plan(a, b, dataflow=d, block_shape=(8, 8, 8),
                               backend="cuda", device="cpu")
            assert ("dense" in jp.aux) == ("dense" in tp.aux)
    finally:
        jbe.dense_threshold, tbe.dense_threshold = saved


# ---------------------------------------------------------------------------
# Selector and workloads
# ---------------------------------------------------------------------------


def test_paper_layers_match():
    assert twl.PAPER_LAYER_GROUPS == jwl.PAPER_LAYER_GROUPS
    assert set(twl.PAPER_LAYERS) == set(jwl.PAPER_LAYERS)
    for name, j in jwl.PAPER_LAYERS.items():
        t = twl.PAPER_LAYERS[name]
        assert (j.m, j.n, j.k, j.sp_a, j.sp_b, j.model) == \
            (t.m, t.n, t.k, t.sp_a, t.sp_b, t.model)
        assert (j.density_a, j.density_b) == (t.density_a, t.density_b)


@pytest.mark.parametrize("block", [(32, 32, 32), (128, 128, 128)])
@pytest.mark.parametrize("layer", sorted(jwl.PAPER_LAYERS))
def test_selection_matches_under_tpu_numbers(layer, block):
    tpu = jsel.TPUSpec()
    spec = tsel.DeviceSpec(**dataclasses.asdict(tpu))
    L = jwl.PAPER_LAYERS[layer]
    kw = dict(m=L.m, k=L.k, n=L.n, density_a=L.density_a,
              density_b=L.density_b, block=block)
    js, ts = jsel.LayerShape(**kw), tsel.LayerShape(**kw)
    assert jsel.select_dataflow(js, tpu) == tsel.select_dataflow(ts, spec)
    for d in DATAFLOWS:
        assert dataclasses.asdict(jsel.estimate(js, d, tpu)) == \
            dataclasses.asdict(tsel.estimate(ts, d, spec))
    assert jsel.select_dataflow(js, tpu, allowed=("op_m", "gust_n")) == \
        tsel.select_dataflow(ts, spec, allowed=("op_m", "gust_n"))


def test_device_spec_is_not_the_tpu():
    """The port's default spec describes the H100, not the TPU v5e."""
    tpu = dataclasses.asdict(jsel.TPUSpec())
    h100 = dataclasses.asdict(tsel.DeviceSpec())
    assert set(tpu) == set(h100)
    for field in ("peak_flops", "hbm_bw", "ici_bw", "vmem_bytes"):
        assert tpu[field] != h100[field], field


def test_network_plan_and_transitions_match():
    tpu = jsel.TPUSpec()
    spec = tsel.DeviceSpec(**dataclasses.asdict(tpu))
    layers = [jwl.PAPER_LAYERS[n] for n in ("SQ5", "R6", "V7", "A2")]
    kw = [dict(m=L.m, k=L.k, n=L.n, density_a=L.density_a,
               density_b=L.density_b, block=(32, 32, 32)) for L in layers]
    assert jsel.plan_network([jsel.LayerShape(**k) for k in kw], tpu) == \
        tsel.plan_network([tsel.LayerShape(**k) for k in kw], spec)
    for p in DATAFLOWS:
        for q in DATAFLOWS:
            assert jsel.transition_needs_conversion(p, q) == \
                tsel.transition_needs_conversion(p, q)
