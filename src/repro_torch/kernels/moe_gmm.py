"""Grouped matmul for MoE expert compute (K3), with its plain version.

MoE dispatch is SpMSpM: the token→expert routing matrix is sparse and the
expert weights are dense per expert.  After the sort by expert (the
Gustavson leader fiber), expert compute is a block-diagonal product: each
row tile multiplies only its group's weight slab.

- :func:`gmm` — ``out[t*bm:(t+1)*bm] = x[t*bm:(t+1)*bm] @ w[group_ids[t]]``.
  A CPU tensor runs :func:`gmm_plain`; a CUDA tensor launches the kernel of
  ``csrc/moe_gmm.cu`` (built by ``build.py`` at first use) or raises.
  ``gmm.launches`` counts kernel launches and nothing else.
- :func:`launch_plan` — the host's choice of the kernel's block rows and
  K split for one call's shapes.
- :func:`pad_groups` — the host padding of ``repro.kernels.moe_gmm``,
  byte-equal to it.
- :func:`pad_groups_device` — the same padding as tensors on the device,
  sized by a static tile bound, so a serving step never waits for the
  host to learn the group sizes.  Tiles past the real count carry the
  idle marker ``-1``, which the kernel and the plain version both answer
  with zero rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import build

__all__ = ["IDLE", "GmmLaunch", "gmm", "gmm_plain", "launch_plan",
           "pad_groups", "pad_groups_device", "tile_bound"]

#: group id of an idle row tile (past the real tiles of the device padding)
IDLE = -1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel's fixed tiling (``csrc/moe_gmm.cu``): output columns per
#: block and the depth of one pipeline slice of the bf16 kernel
BLOCK_N = 64
SLICE_K = 64
#: blocks a launch should give the card's 132 SMs before K is left whole
TARGET_BLOCKS = 2 * 132
#: least depth one K split keeps: four pipeline slices
MIN_SPLIT_K = 4 * SLICE_K
#: CUDA's limit on a grid's y and z extents
_MAX_GRID_YZ = 65535


def _check_shapes(x, w, group_ids, bm, bk, bn):
    if x.dim() != 2 or w.dim() != 3 or group_ids.dim() != 1:
        raise ValueError(f"gmm: want x (M, K), w (G, K, N), group_ids "
                         f"(M/bm,), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_ids.shape)}")
    m, k = x.shape
    g, k2, n = w.shape
    if k != k2:
        raise ValueError(f"gmm: depths disagree, x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if min(bm, bk, bn) <= 0 or m % bm or k % bk or n % bn:
        raise ValueError(f"gmm: (M, K, N) = {(m, k, n)} must be multiples "
                         f"of (bm, bk, bn) = {(bm, bk, bn)}")
    if group_ids.shape[0] != m // bm:
        raise ValueError(f"gmm: {group_ids.shape[0]} group ids for "
                         f"{m // bm} row tiles")
    return m, k, n, g


def gmm_plain(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor, *,
              bm: int = 128, bk: int = 128, bn: int = 128,
              out_dtype=None) -> torch.Tensor:
    """K3 in plain PyTorch: one ``bmm`` of each row tile against its group's
    slab, summed in fp32, cast to ``out_dtype`` (default ``x``'s).

    Idle tiles (a group id outside ``[0, G)``) give zero rows.
    """
    m, k, n, g = _check_shapes(x, w, group_ids, bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    gid = group_ids.long()
    idle = (gid < 0) | (gid >= g)
    tiles = x.float().reshape(m // bm, bm, k)
    out = torch.bmm(tiles, w.float()[torch.where(idle, 0, gid)])
    out = torch.where(idle[:, None, None], torch.zeros_like(out), out)
    return out.reshape(m, n).to(out_dtype)


# -- kernel launch -----------------------------------------------------------


class GmmLaunch(NamedTuple):
    """How one K3 call is cut into CUDA blocks."""

    rows: int        # block row extent: 16 (bm <= 16) or 64
    row_blocks: int  # row tiles x row sub-tiles of ``rows``
    col_blocks: int  # BLOCK_N-column blocks
    splits: int      # K splits; > 1 adds the fixed-order reduction pass
    k_len: int       # depth of each split, a multiple of SLICE_K

    @property
    def grid(self) -> Tuple[int, int, int]:
        """The CUDA grid of the main kernel."""
        return (self.row_blocks, self.col_blocks, self.splits)


def launch_plan(m: int, k: int, n: int, bm: int,
                dtype=torch.bfloat16) -> GmmLaunch:
    """The block rows and K split of one call, from its shapes alone.

    16-row blocks for ``bm <= 16`` (the sort path's decode and prefill),
    64-row sub-tiles otherwise.  bf16 calls whose row tiles x column blocks
    come to fewer than :data:`TARGET_BLOCKS` split K into pieces of at least
    :data:`MIN_SPLIT_K`, so a call with few tiles still fills the card.  The
    host does not know how many tiles are idle (that would need a sync), so
    it counts them all.  fp32 calls run on the CUDA cores with no split.
    """
    rows = 16 if bm <= 16 else 64
    row_blocks = (m // bm) * -(-bm // rows)
    cols = -(-n // BLOCK_N)
    blocks = row_blocks * cols
    splits = 1
    if dtype == torch.bfloat16 and 0 < blocks < TARGET_BLOCKS:
        want = -(-TARGET_BLOCKS // blocks)
        splits = max(1, min(want, k // MIN_SPLIT_K))
    k_len = max(SLICE_K, -(-(-(-k // splits)) // SLICE_K) * SLICE_K)
    splits = max(1, -(-k // k_len))
    return GmmLaunch(rows, row_blocks, cols, splits, k_len)


def _lib() -> ctypes.CDLL:
    lib = build.library("moe_gmm")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flexagon_gmm.argtypes = [p, p, p] + [i] * 10 + [p, p, p]
        lib.flexagon_gmm.restype = i
        lib.flexagon_gmm_error_string.argtypes = [i]
        lib.flexagon_gmm_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _check_launch(x, w, group_ids, out_dtype):
    """Everything the kernel assumes beyond the shapes, checked on the host."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gmm: the CUDA kernel takes CUDA tensors, got {dev}")
    if w.device != dev or group_ids.device != dev:
        raise ValueError(f"gmm: x on {dev}, w on {w.device}, group_ids on "
                         f"{group_ids.device}; want one device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"gmm: x and w must both be float32 or bfloat16, "
                         f"got {x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"gmm: out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if group_ids.dtype != torch.int32:
        raise ValueError(f"gmm: group_ids must be int32, got "
                         f"{group_ids.dtype}")
    for label, t in (("x", x), ("w", w), ("group_ids", group_ids)):
        if not t.is_contiguous():
            raise ValueError(f"gmm: {label} must be contiguous")
    if max(x.numel(), w.numel()) >= 2 ** 31:
        raise ValueError("gmm: the kernel's int extents need fewer than "
                         "2**31 elements per operand")


def gmm(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor, *,
        bm: int = 128, bk: int = 128, bn: int = 128,
        out_dtype=None) -> torch.Tensor:
    """Grouped matmul: ``out[t*bm:(t+1)*bm] = x[t*bm:(t+1)*bm] @
    w[group_ids[t]]``, summed in fp32, returned in ``out_dtype`` (default
    ``x``'s).

    Requires ``M % bm == K % bk == N % bn == 0`` (callers pad; see
    :func:`pad_groups` / :func:`pad_groups_device`).  A group id outside
    ``[0, G)`` marks an idle tile, whose rows come back zero (the device
    padding marks them :data:`IDLE`); the kernel reads no weights for it.
    ``bk`` and ``bn`` are the reference's tiling and only checked here;
    ``bm`` is the group granularity.
    """
    if x.device.type == "cpu":
        return gmm_plain(x, w, group_ids, bm=bm, bk=bk, bn=bn,
                         out_dtype=out_dtype)
    lib = _lib()
    m, k, n, g = _check_shapes(x, w, group_ids, bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    _check_launch(x, w, group_ids, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(m, k, n, bm, x.dtype)
    if plan.col_blocks > _MAX_GRID_YZ:
        raise ValueError(f"gmm: N = {n} gives {plan.col_blocks} column "
                         f"blocks, over the grid's {_MAX_GRID_YZ}")
    part = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.flexagon_gmm(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(group_ids.data_ptr()), m, k, n, g, bm,
        _DTYPES[x.dtype], _DTYPES[out_dtype], plan.rows, plan.splits,
        plan.k_len, ctypes.c_void_p(part.data_ptr() if part is not None
                                    else None),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err:
        msg = lib.flexagon_gmm_error_string(err).decode()
        raise RuntimeError(f"gmm: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    gmm.launches += 1
    return out


gmm.launches = 0


# -- padding -----------------------------------------------------------------


def pad_groups(group_sizes: np.ndarray, bm: int):
    """Round each group up to a multiple of ``bm`` (host, numpy).

    Returns (padded_sizes, row_tile_group_ids, scatter_index) where
    ``scatter_index[i]`` is the padded-row position of original row *i*.
    """
    group_sizes = np.asarray(group_sizes)
    padded = ((group_sizes + bm - 1) // bm) * bm
    padded = np.maximum(padded, 0)
    tile_counts = padded // bm
    gids = np.repeat(np.arange(len(group_sizes)), tile_counts).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    scatter = np.concatenate([
        starts[g] + np.arange(group_sizes[g]) for g in range(len(group_sizes))
    ]) if group_sizes.sum() else np.zeros(0, np.int64)
    return padded, gids, scatter.astype(np.int32)


def tile_bound(rows: int, groups: int, bm: int) -> int:
    """Row tiles that any split of ``rows`` rows into ``groups`` groups pads
    to: each group wastes less than one tile."""
    return -(-rows // bm) + groups


def pad_groups_device(group_sizes: torch.Tensor, bm: int, rows: int):
    """:func:`pad_groups` on the device, with no host sync.

    ``group_sizes`` is an integer tensor summing to ``rows`` (a static
    count, e.g. tokens x top-k).  Returns ``(group_ids, scatter)``:
    ``group_ids`` has :func:`tile_bound` entries, equal to
    :func:`pad_groups`' on the real tiles and :data:`IDLE` after them;
    ``scatter`` (``rows``,) int32 equals :func:`pad_groups`' scatter index.
    """
    if group_sizes.dim() != 1 or group_sizes.numel() == 0:
        raise ValueError(f"pad_groups_device: want a non-empty 1-d tensor of "
                         f"group sizes, got shape {tuple(group_sizes.shape)}")
    dev = group_sizes.device
    sizes = group_sizes.long()
    tiles = (sizes + bm - 1) // bm
    tile_end = torch.cumsum(tiles, 0)
    n_tiles = tile_bound(rows, sizes.numel(), bm)
    t = torch.arange(n_tiles, device=dev)
    gids = torch.searchsorted(tile_end, t, right=True)
    group_ids = torch.where(t < tile_end[-1], gids, IDLE).to(torch.int32)
    row_end = torch.cumsum(sizes, 0)
    r = torch.arange(rows, device=dev)
    g_of = torch.searchsorted(row_end, r, right=True)
    pad_start = (tile_end - tiles) * bm
    scatter = pad_start[g_of] + r - (row_end - sizes)[g_of]
    return group_ids, scatter.to(torch.int32)
