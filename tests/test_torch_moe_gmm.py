"""Kernel K3 (grouped matmul) of the port against the JAX package's.

On the CPU ``repro_torch.kernels.moe_gmm.gmm`` runs its plain version; the
JAX ``gmm`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it.  Same numpy inputs, fp32,
``rtol = atol = 1e-4`` (both sum in fp32, in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import gmm as jax_gmm
from repro.kernels.moe_gmm import pad_groups as jax_pad_groups

from repro_torch.kernels import moe_gmm as tg

SIZES = [[8, 16, 0, 24], [0, 0, 8], [32]]


def _padded_case(sizes, bm, k=16, n=24, seed=7):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes)
    x = rng.standard_normal((int(sizes.sum()), k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    padded, gids, scatter = jax_pad_groups(sizes, bm)
    xp = np.zeros((int(padded.sum()), k), np.float32)
    xp[scatter] = x
    return x, w, xp, gids, scatter


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("sizes", SIZES, ids=["mixed", "leading-empty",
                                              "one-group"])
def test_gmm_plain_matches_pallas_interpret(sizes, bm):
    _, w, xp, gids, scatter = _padded_case(sizes, bm)
    want = np.asarray(jax_gmm(jnp.asarray(xp), jnp.asarray(w), gids, bm=bm,
                              bk=8, bn=8, interpret=True))
    got = tg.gmm(torch.as_tensor(xp), torch.as_tensor(w),
                 torch.as_tensor(gids), bm=bm, bk=8, bn=8)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


PAD_CASES = [[8, 16, 0, 24], [0, 0, 8], [32], [0, 0, 0], [5], [3, 0, 17, 1],
             [0]]


@pytest.mark.parametrize("bm", [4, 8, 16])
@pytest.mark.parametrize("sizes", PAD_CASES,
                         ids=lambda s: "-".join(map(str, s)))
def test_pad_groups_byte_equal(sizes, bm):
    """Host copy and device form against JAX's ``pad_groups``, all-empty and
    single-group cases included; the device form marks the tiles past the
    real ones idle."""
    want = jax_pad_groups(np.asarray(sizes), bm)
    got = tg.pad_groups(np.asarray(sizes), bm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rows = int(sum(sizes))
    gids, scatter = tg.pad_groups_device(torch.tensor(sizes), bm, rows)
    n_real = want[1].size
    assert gids.shape == (tg.tile_bound(rows, len(sizes), bm),)
    assert gids.dtype == torch.int32 and scatter.dtype == torch.int32
    assert gids[:n_real].numpy().tobytes() == want[1].tobytes()
    assert (gids[n_real:] == tg.IDLE).all()
    assert scatter.numpy().tobytes() == want[2].tobytes()


def test_idle_tiles_give_zero_rows():
    """A device padding with idle tiles: real rows match JAX's ``gmm`` on
    the host padding, idle rows are zero."""
    sizes = np.array([3, 0, 9, 1])
    bm = 4
    x, w, xp, jgids, scatter = _padded_case(sizes, bm)
    gids, tscatter = tg.pad_groups_device(torch.as_tensor(sizes), bm,
                                          int(sizes.sum()))
    xd = torch.zeros((gids.shape[0] * bm, x.shape[1]))
    xd[tscatter.long()] = torch.as_tensor(x)
    out = tg.gmm(xd, torch.as_tensor(w), gids, bm=bm, bk=8, bn=8)
    want = np.asarray(jax_gmm(jnp.asarray(xp), jnp.asarray(w), jgids, bm=bm,
                              bk=8, bn=8, interpret=True))
    np.testing.assert_allclose(out[tscatter.long()].numpy(), want[scatter],
                               rtol=1e-4, atol=1e-4)
    assert not out[jgids.size * bm:].any()
    # any id outside [0, G) is idle, not an out-of-range read: a real
    # tile relabelled G gives zero rows
    assert out[:bm].any()
    gids[0] = len(sizes)
    assert not tg.gmm(xd, torch.as_tensor(w), gids, bm=bm, bk=8, bn=8
                      )[:bm].any()


def test_gmm_bf16_rounds_an_fp32_sum():
    """bf16 in, bf16 out: the fp32 sum rounded once, as the kernel does."""
    _, w, xp, gids, _ = _padded_case([8, 8], 8)
    xb = torch.as_tensor(xp).to(torch.bfloat16)
    wb = torch.as_tensor(w).to(torch.bfloat16)
    got = tg.gmm(xb, wb, torch.as_tensor(gids), bm=8, bk=8, bn=8)
    want = tg.gmm(xb, wb, torch.as_tensor(gids), bm=8, bk=8, bn=8,
                  out_dtype=torch.float32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("bad", ["k", "bm", "gids", "bk"])
def test_gmm_rejects_shapes_outside_the_contract(bad):
    x, w, gids = torch.zeros(16, 8), torch.zeros(2, 8, 8), \
        torch.zeros(2, dtype=torch.int32)
    kw = dict(bm=8, bk=8, bn=8)
    if bad == "k":
        w = torch.zeros(2, 4, 8)
    elif bad == "bm":
        kw["bm"] = 5
    elif bad == "gids":
        gids = torch.zeros(3, dtype=torch.int32)
    else:
        kw["bk"] = 3
    with pytest.raises(ValueError):
        tg.gmm(x, w, gids, **kw)
