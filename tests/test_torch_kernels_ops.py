"""The port's one-shot kernel surface (``repro_torch.kernels``: ``ops.py``,
the grouped-matmul oracles) against the JAX package's ``repro.kernels``,
case for case with ``tests/test_kernels.py`` and
``tests/test_backends.py::test_flexagon_spmm_warns_deprecated``.

The same numpy operands go through both packages; the port runs on the
CPU (the ``reference`` backend, and the ``cuda`` backend's plain versions
of K1/K2), the JAX side on its ``reference`` backend.  Tolerances are
``tests/test_kernels.py``'s: 1e-4 in fp32, 2e-2 for bf16 operands.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import kernels as jk
from repro.core.formats import random_sparse_dense

import repro_torch.kernels as tk

SHAPES = [(16, 16, 16), (32, 16, 48), (8, 64, 24)]
DENSITIES = [(0.0, 0.5), (0.3, 0.7), (1.0, 1.0), (0.15, 0.15)]
BACKENDS = ["reference", "cuda"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _operands(seed, m, k, n, da, db):
    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=(8, 8))
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=(8, 8))
    return a, b


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dens", DENSITIES)
@pytest.mark.parametrize("dataflow", ["ip_m", "op_m", "gust_m"])
def test_spmm_with_dataflow_matches_reference(shape, dens, dataflow, backend):
    m, k, n = shape
    a, b = _operands(hash((shape, dens, dataflow)) % 2 ** 31, m, k, n, *dens)
    want = np.asarray(jk.spmm_with_dataflow(a, b, dataflow, (8, 8, 8),
                                            use_pallas=False))
    got = tk.spmm_with_dataflow(a, b, dataflow, (8, 8, 8), backend=backend,
                                device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), tk.spmm_ref(a, b).numpy(), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dataflow", ["ip_n", "op_n", "gust_n"])
def test_spmm_n_stationary(dataflow, backend):
    a, b = _operands(3, 24, 16, 40, 0.4, 0.6)
    want = np.asarray(jk.spmm_ref(a, b))
    got = tk.spmm_with_dataflow(a, b, dataflow, (8, 8, 8), backend=backend,
                                device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_spmm_dtypes(dtype):
    a, b = _operands(5, 16, 16, 16, 0.5, 0.5)
    if dtype == "bfloat16":
        # the same bf16-rounded operands in both packages
        a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        b = np.asarray(jnp.asarray(b, jnp.bfloat16), np.float32)
        ta = torch.as_tensor(a).to(torch.bfloat16)
        tb = torch.as_tensor(b).to(torch.bfloat16)
    else:
        ta, tb = a, b
    ref = np.asarray(jk.spmm_ref(a, b), np.float32)
    for df in ("ip_m", "op_m", "gust_m"):
        got = tk.spmm_with_dataflow(ta, tb, df, (8, 8, 8), device="cpu")
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                                   atol=2e-2)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 16), st.floats(0.0, 1.0), st.floats(0.1, 1.0))
def test_flexagon_spmm_auto_matches_reference(seed, da, db):
    """Whatever the selector picks, the port picks the same and matches
    the oracle."""
    a, b = _operands(seed, 24, 24, 24, da, db)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got, chosen = tk.flexagon_spmm(a, b, block_shape=(8, 8, 8),
                                       device="cpu")
        _, want = jk.flexagon_spmm(a, b, block_shape=(8, 8, 8),
                                   use_pallas=False)
    assert chosen == want
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.spmm_ref(a, b)),
                               **TOL)


def test_flexagon_spmm_warns_deprecated():
    a, b = _operands(13, 16, 16, 16, 0.5, 0.5)
    with pytest.warns(DeprecationWarning, match="re-plans on every call"):
        out, chosen = tk.flexagon_spmm(a, b, block_shape=(8, 8, 8),
                                       backend="reference", device="cpu")
    assert chosen in ("ip_m", "op_m", "gust_m", "ip_n", "op_n", "gust_n")
    np.testing.assert_allclose(out.numpy(), a @ b, **TOL)


@pytest.mark.parametrize("sizes", [[8, 16, 0, 24], [0, 0, 8], [32]])
def test_gmm_vs_oracle(sizes):
    rng = np.random.default_rng(7)
    sizes = np.asarray(sizes)
    m = int(sizes.sum())
    x = rng.standard_normal((m, 16)).astype(np.float32)
    w = rng.standard_normal((len(sizes), 16, 24)).astype(np.float32)
    padded, gids, scatter = tk.pad_groups(sizes, 8)
    want = jk.pad_groups(sizes, 8)
    for got_part, want_part in zip((padded, gids, scatter), want):
        np.testing.assert_array_equal(np.asarray(got_part),
                                      np.asarray(want_part))
    xp = np.zeros((int(padded.sum()), 16), np.float32)
    xp[scatter] = x
    out = tk.gmm(torch.as_tensor(xp), torch.as_tensor(w),
                 torch.as_tensor(np.asarray(gids)), bm=8, bk=8, bn=8)
    ref = tk.gmm_ref(x, w, sizes)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jk.gmm_ref(x, w,
                                                                  sizes)),
                               **TOL)
    np.testing.assert_allclose(out.numpy()[scatter], ref.numpy(), **TOL)


def test_moe_combine_ref_matches_reference():
    from repro.kernels.ref import moe_combine_ref

    rng = np.random.default_rng(11)
    out = rng.standard_normal((6, 3, 8)).astype(np.float32)
    weights = rng.random((6, 3)).astype(np.float32)
    np.testing.assert_allclose(tk.moe_combine_ref(out, weights).numpy(),
                               np.asarray(moe_combine_ref(out, weights)),
                               **TOL)


def test_exports_match_reference():
    for name in ("flexagon_spmm", "spmm_with_dataflow", "gmm", "pad_groups",
                 "gmm_ref", "spmm_ref"):
        assert hasattr(jk, name) and callable(getattr(tk, name)), name
    assert callable(tk.moe_combine_ref)
