"""The port's compressed sparse FFN against the JAX package's, with the
weights carried across by ``repro_torch.convert``.

d_model 64, d_ff 96, block 16, on the CPU; the JAX side runs the
``pallas`` backend in interpret mode.  Tolerance ``rtol=atol=1e-4``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SparseOperand as JaxSparseOperand
from repro.configs.base import ModelConfig
from repro.core.selector import TPUSpec
from repro.models.ffn import ffn_init
from repro.models.sparse_linear import compress_ffn as jax_compress_ffn
from repro.models.sparse_linear import sparse_ffn_apply as jax_sparse_ffn

from repro_torch import compress_ffn, sparse_ffn_apply
from repro_torch.convert import ffn_params_from_jax, sparse_operand_from_jax
from repro_torch.core.selector import DeviceSpec


@pytest.fixture(autouse=True)
def _no_verify(monkeypatch):
    # the port has no plan verifier yet (ROADMAP item 10): verify=True and
    # REPRO_VERIFY=1 raise, so these tests plan with verification off
    monkeypatch.setenv("REPRO_VERIFY", "0")


TOL = dict(rtol=1e-4, atol=1e-4)
SPEC = DeviceSpec(**dataclasses.asdict(TPUSpec()))


@pytest.fixture(scope="module")
def jax_params():
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=4, d_ff=96, vocab=64, ffn_block_sparsity=0.4)
    params = ffn_init(jax.random.PRNGKey(0), cfg)
    # a 16x16-block mask, as tests/test_sparse_ffn.py makes it
    mask = np.random.default_rng(9).random((4, 6)) > 0.4
    params["block_mask"] = jnp.asarray(mask, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _x(seed, shape=(2, 8, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_sparse_ffn_matches_jax(jax_params, backend):
    jcomp = jax_compress_ffn(jax_params, tokens=16, block=16,
                             backend="pallas")
    comp = compress_ffn(ffn_params_from_jax(jax_params, device="cpu"),
                        tokens=16, block=16, backend=backend, device="cpu",
                        spec=SPEC)
    assert (comp.dataflow_in, comp.dataflow_out) == \
        (jcomp.dataflow_in, jcomp.dataflow_out)
    for seed, shape in ((1, (2, 8, 64)), (2, (1, 5, 64))):
        x = _x(seed, shape)
        want = np.asarray(jax_sparse_ffn(jcomp, jnp.asarray(x)))
        got = sparse_ffn_apply(comp, torch.as_tensor(x))
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matches_masked_dense_in_fp64(jax_params):
    params = ffn_params_from_jax(jax_params, device="cpu")
    comp = compress_ffn(params, tokens=16, block=16, backend="cuda",
                        device="cpu")
    x = torch.as_tensor(_x(3))
    mask = np.kron(jax_params["block_mask"], np.ones((16, 16)))
    wg = jax_params["w_gate"]["w"] * mask
    wu = jax_params["w_up"]["w"] * mask
    wd = jax_params["w_down"]["w"] * mask.T
    x2 = x.numpy().reshape(-1, 64).astype(np.float64)
    g = x2 @ wg
    ref = ((g / (1 + np.exp(-g))) * (x2 @ wu)) @ wd
    np.testing.assert_allclose(sparse_ffn_apply(comp, x).numpy()
                               .reshape(-1, 64), ref, **TOL)


def test_compression_respects_sparsity(jax_params):
    comp = compress_ffn(ffn_params_from_jax(jax_params, device="cpu"),
                        tokens=16, block=16, backend="cuda", device="cpu")
    mask = np.asarray(jax_params["block_mask"]) > 0
    assert comp.w_gate.nnzb == int(mask.sum())
    assert comp.w_down.nnzb == int(mask.T.sum())


def test_plans_built_once_per_token_shape(jax_params):
    comp = compress_ffn(ffn_params_from_jax(jax_params, device="cpu"),
                        tokens=16, block=16, backend="cuda", device="cpu")
    assert comp.plan_builds == 1
    x = torch.as_tensor(_x(4))
    for _ in range(3):
        sparse_ffn_apply(comp, x)
    assert comp.plan_builds == 1 and comp.plan_hits == 3
    x2 = torch.as_tensor(_x(5, (1, 8, 64)))
    sparse_ffn_apply(comp, x2)
    sparse_ffn_apply(comp, x2)
    assert comp.plan_builds == 2 and comp.plan_hits == 4
    assert comp(x2).shape == x2.shape          # nn.Module call path


@pytest.mark.parametrize("kwarg", ["mesh", "partition"])
def test_sharded_compress_ffn_matches_jax(jax_params, kwarg):
    """``mesh=`` / ``partition=`` (which raised until the distribution
    slice) shard every matmul of the FFN; the result matches the JAX
    package's compressed FFN."""
    from repro_torch.dist import DistPartition, ShardedPlan
    from repro_torch.launch.mesh import make_virtual_mesh

    kw = {"mesh": make_virtual_mesh(2, "cpu")} if kwarg == "mesh" \
        else {"partition": DistPartition(axis="k", shards=2)}
    jcomp = jax_compress_ffn(jax_params, tokens=16, block=16,
                             backend="reference")
    comp = compress_ffn(ffn_params_from_jax(jax_params, device="cpu"),
                        tokens=16, block=16, backend="cuda", device="cpu",
                        spec=SPEC, **kw)
    entry = comp.specialize(16)
    assert isinstance(entry.plan_in, ShardedPlan)
    assert isinstance(entry.plan_out, ShardedPlan)
    assert entry.plan_in.n_shards == entry.plan_out.n_shards == 2
    x = _x(4)
    want = np.asarray(jax_sparse_ffn(jcomp, jnp.asarray(x)))
    np.testing.assert_allclose(
        sparse_ffn_apply(comp, torch.as_tensor(x)).numpy(), want, **TOL)


def test_unported_arguments_raise(jax_params):
    params = ffn_params_from_jax(jax_params, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compress_ffn(params, tokens=16, block=16, device="cpu", verify=True)


@pytest.mark.parametrize("fmt", ["bcsr", "bcsc", "csr", "csc"])
def test_sparse_operand_from_jax(fmt):
    x = _x(6, (24, 40)) * (np.random.default_rng(7).random((24, 40)) > 0.5)
    jop = JaxSparseOperand.from_dense(x, fmt, (8, 8))
    op = sparse_operand_from_jax(jop, device="cpu")
    assert op.fmt.value == fmt and op.shape == (24, 40)
    dense = op.todense()
    dense = dense.numpy() if isinstance(dense, torch.Tensor) else dense
    np.testing.assert_array_equal(dense, np.asarray(jop.todense()))
