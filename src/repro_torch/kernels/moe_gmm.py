"""Grouped matmul for MoE expert compute (K3), with its plain version.

MoE dispatch is SpMSpM: the token→expert routing matrix is sparse and the
expert weights are dense per expert.  After the sort by expert (the
Gustavson leader fiber), expert compute is a block-diagonal product: each
row tile multiplies only its group's weight slab.

- :func:`gmm` — ``out[t*bm:(t+1)*bm] = x[t*bm:(t+1)*bm] @ w[group_ids[t]]``,
  differentiable through :class:`GroupedMatmul`.  A CPU tensor runs
  :func:`gmm_plain`; a CUDA tensor launches the kernel of
  ``csrc/moe_gmm.cu`` (built by ``build.py`` at first use) or raises.
  ``gmm.launches`` counts kernel launches and nothing else: the forward's
  and the backward's ``dx`` (K3 on the transposed weights).  Both
  products are torch operators, ``repro_torch::gmm`` and
  ``repro_torch::gmm_wgrad``: a meta tensor gets its output's shape, and
  ``torch.utils.flop_counter`` counts them.
- :func:`gmm_wgrad` (K3w) — the weight gradient
  ``dw[g] = sum over g's row tiles t of x_t^T @ dy_t``, summed in fp32:
  :func:`gmm_wgrad_plain` on the CPU, a kernel of the same source on the
  card.  ``gmm_wgrad.launches`` counts its launches.  The TPU package has no
  kernel for it: XLA differentiates ``jax.lax.ragged_dot``.
- :func:`launch_plan` — the host's choice of K3's block rows and K split
  for one call's shapes; :func:`wgrad_plan` — K3w's kernel and tile.
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
from torch.utils.flop_counter import register_flop_formula

from .. import obs
from . import build

__all__ = ["IDLE", "GmmLaunch", "GroupedMatmul", "WgradLaunch", "gmm",
           "gmm_plain", "gmm_wgrad", "gmm_wgrad_plain", "launch_plan",
           "pad_groups", "pad_groups_device", "tile_bound", "wgrad_plan"]

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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' sum type: fp32, or fp64 for fp64 inputs (the
    gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def gmm_plain(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor, *,
              bm: int = 128, bk: int = 128, bn: int = 128,
              out_dtype=None) -> torch.Tensor:
    """K3 in plain PyTorch: one ``bmm`` of each row tile against its group's
    slab, summed in fp32 (fp64 for fp64 inputs), cast to ``out_dtype``
    (default ``x``'s).

    Idle tiles (a group id outside ``[0, G)``) give zero rows.
    """
    m, k, n, g = _check_shapes(x, w, group_ids, bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    acc = _acc_dtype(x)
    gid = group_ids.long()
    idle = (gid < 0) | (gid >= g)
    tiles = x.to(acc).reshape(m // bm, bm, k)
    out = torch.bmm(tiles, w.to(acc)[torch.where(idle, 0, gid)])
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
        lib.flexagon_gmm_wgrad.argtypes = [p, p, p] + [i] * 8 + [p, p]
        lib.flexagon_gmm_wgrad.restype = i
        lib.flexagon_gmm_error_string.argtypes = [i]
        lib.flexagon_gmm_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _check_launch(name, x, w, group_ids, out_dtype):
    """Everything a kernel of this file assumes beyond the shapes, checked
    on the host; ``w`` is K3's weights or K3w's ``dy``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    if w.device != dev or group_ids.device != dev:
        raise ValueError(f"{name}: operands on {dev}, {w.device} and "
                         f"{group_ids.device}; want one device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name}: both operands must be float32 or "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if group_ids.dtype != torch.int32:
        raise ValueError(f"{name}: group_ids must be int32, got "
                         f"{group_ids.dtype}")
    for label, t in (("x", x), ("w", w), ("group_ids", group_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if max(x.numel(), w.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel's int extents need fewer than "
                         "2**31 elements per operand")


def _k3_launch(x, w, group_ids, bm, bk, bn, out_dtype) -> torch.Tensor:
    """One launch of K3 on the card (counted in ``gmm.launches``)."""
    lib = _lib()
    m, k, n, g = _check_shapes(x, w, group_ids, bm, bk, bn)
    _check_launch("gmm", x, w, group_ids, out_dtype)
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


# -- the products as torch operators ------------------------------------------
#
# ``repro_torch::gmm`` and ``repro_torch::gmm_wgrad`` carry K3 and K3w
# through torch's dispatcher, so torch's instruments see them: a CPU tensor
# runs the plain version, a CUDA tensor the kernel (or raises), a meta
# tensor only allocates the output (the dry-run counts the products there),
# and ``torch.utils.flop_counter`` counts each by its formula below.  No
# other device has an implementation.


@torch.library.custom_op("repro_torch::gmm", mutates_args=(),
                         device_types="cpu")
def _gmm_op(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
            bm: int, bk: int, bn: int, out_dtype: torch.dtype
            ) -> torch.Tensor:
    return gmm_plain(x, w, group_ids, bm=bm, bk=bk, bn=bn,
                     out_dtype=out_dtype)


_gmm_op.register_kernel("cuda")(_k3_launch)


@_gmm_op.register_fake
def _(x, w, group_ids, bm, bk, bn, out_dtype):
    m, _k, n, _g = _check_shapes(x, w, group_ids, bm, bk, bn)
    return x.new_empty((m, n), dtype=out_dtype)


@register_flop_formula(torch.ops.repro_torch.gmm)
def _gmm_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """``2 M K N`` over the padded rows M.  M counts the idle tiles of the
    device padding too: the host cannot know how many are idle without a
    sync, and the kernel skips them."""
    (m, k), n = x_shape, w_shape[2]
    return 2 * m * k * n


def _k3(x, w, group_ids, bm, bk, bn, out_dtype) -> torch.Tensor:
    """One K3 call with no autograd: the plain version for a CPU tensor,
    one launch of the kernel for a CUDA tensor (``repro_torch::gmm``)."""
    return torch.ops.repro_torch.gmm(x, w, group_ids, bm, bk, bn, out_dtype)


class GroupedMatmul(torch.autograd.Function):
    """K3 with its gradient: the forward is :func:`_k3`; the backward gives

    - ``dx = K3(dy, w^T)`` on the same group ids and ``bm`` (idle tiles
      give zero rows), in ``x``'s dtype.  On the card ``w^T`` is a copy of
      each slab, transposed (``w.transpose(1, 2).contiguous()``);
    - ``dw = K3w(x, dy)`` (:func:`gmm_wgrad`'s :func:`_k3w`), summed in
      fp32, zero for a
      group with no rows, in ``w``'s dtype;
    - no gradient for ``group_ids`` or the tiling.

    Both products run inside the span ``moe.experts.backward``.

    ``dy`` is taken in the operands' dtype for both products.  A CUDA
    tensor never reaches a plain version: each product launches its kernel
    or raises.
    """

    @staticmethod
    def forward(ctx, x, w, group_ids, bm, bk, bn, out_dtype):
        ctx.save_for_backward(x, w, group_ids)
        ctx.tiling = (bm, bk, bn)
        return _k3(x, w, group_ids, bm, bk, bn, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_ids = ctx.saved_tensors
        bm, bk, bn = ctx.tiling
        dx = dw = None
        with obs.span("moe.experts.backward"):
            if ctx.needs_input_grad[0]:
                dx = _k3(dy.to(w.dtype).contiguous(),
                         w.transpose(1, 2).contiguous(), group_ids, bm, bn,
                         bk, x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _k3w(x, dy.to(x.dtype).contiguous(), group_ids,
                          w.shape[0], bm, w.dtype)
        return dx, dw, None, None, None, None, None


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
    ``bm`` is the group granularity.  Differentiable in ``x`` and ``w``
    (:class:`GroupedMatmul`), on both devices.
    """
    _check_shapes(x, w, group_ids, bm, bk, bn)
    return GroupedMatmul.apply(x, w, group_ids, bm, bk, bn,
                               out_dtype or x.dtype)


gmm.launches = 0


# -- K3w: the weight gradient --------------------------------------------------


def _check_wgrad_shapes(x, dy, group_ids, groups, bm):
    if x.dim() != 2 or dy.dim() != 2 or group_ids.dim() != 1:
        raise ValueError(f"gmm_wgrad: want x (M, K), dy (M, N), group_ids "
                         f"(M/bm,), got {tuple(x.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(group_ids.shape)}")
    (m, k), n = x.shape, dy.shape[1]
    if dy.shape[0] != m:
        raise ValueError(f"gmm_wgrad: x has {m} rows, dy {dy.shape[0]}")
    if bm <= 0 or m % bm or group_ids.shape[0] != m // bm:
        raise ValueError(f"gmm_wgrad: {group_ids.shape[0]} group ids for "
                         f"M = {m} at bm = {bm}")
    if not 0 < groups <= _MAX_GRID_YZ:
        raise ValueError(f"gmm_wgrad: {groups} groups, want 1 to "
                         f"{_MAX_GRID_YZ}")
    return m, k, n


def gmm_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                    group_ids: torch.Tensor, groups: int, *, bm: int = 128,
                    out_dtype=None) -> torch.Tensor:
    """K3w in plain PyTorch: for each group, its rows of ``x``, transposed,
    times its rows of ``dy``, in fp32 (fp64 for fp64 inputs); (G, K, N) in
    ``out_dtype`` (default ``x``'s).  Idle tiles count for no group."""
    m, k, n = _check_wgrad_shapes(x, dy, group_ids, groups, bm)
    acc = _acc_dtype(x)
    row_group = group_ids.long().repeat_interleave(bm)
    xf, df = x.to(acc), dy.to(acc)
    out = torch.zeros((groups, k, n), dtype=acc, device=x.device)
    for g in range(groups):
        rows = row_group == g
        out[g] = xf[rows].T @ df[rows]
    return out.to(out_dtype or x.dtype)


class WgradLaunch(NamedTuple):
    """How one K3w call runs (``csrc/moe_gmm.cu``)."""

    variant: str                 # "tma", "mma" (bf16) or "fma" (fp32)
    tile: Tuple[int, int]        # dw rows (K) x columns (N) a block owns
    grid: Tuple[int, int]        # (K blocks x N blocks, groups)


#: K3w's TMA kernel's dw tile (TW_BM x TW_BN in the source)
WGRAD_TILE = (128, 256)
#: words of its bitmap of a group's tiles in shared memory (TW_MAP_WORDS)
WGRAD_MAP_WORDS = 4096
#: the general kernels' dw tile
WGRAD_GENERAL_TILE = (64, 64)


def wgrad_plan(m: int, k: int, n: int, groups: int, bm: int,
               dtype=torch.bfloat16, aligned: bool = True) -> WgradLaunch:
    """K3w's kernel and tile for one call, from its shapes and its
    operands' 16-byte alignment alone.

    bf16 takes ``wgrad_tma_kernel`` (128 x 256 dw tiles, TMA and wgmma)
    where TMA can read the operands: K and N multiples of 8 (16-byte rows),
    16-byte-aligned bases, ``bm`` a multiple of 16 (a stage's rows are
    whole 16-row wgmma steps of listed tiles) and rows to read.  Every
    other bf16 call takes ``wgrad_mma_kernel`` and fp32
    ``wgrad_fma_kernel``, 64 x 64 tiles.  No variant splits the rows: at
    granite's training shapes the TMA kernel runs 512 blocks.
    """
    if dtype == torch.bfloat16 and aligned and k % 8 == 0 and n % 8 == 0 \
            and bm % 16 == 0 and m > 0:
        variant, tile = "tma", WGRAD_TILE
    else:
        variant = "mma" if dtype == torch.bfloat16 else "fma"
        tile = WGRAD_GENERAL_TILE
    blocks = -(-k // tile[0]) * -(-n // tile[1])
    return WgradLaunch(variant, tile, (blocks, groups))


def _k3w_launch(x, dy, group_ids, groups, bm, out_dtype) -> torch.Tensor:
    """One launch of the K3w kernel :func:`wgrad_plan` picks (counted in
    ``gmm_wgrad.launches``)."""
    lib = _lib()
    m, k, n = _check_wgrad_shapes(x, dy, group_ids, groups, bm)
    _check_launch("gmm_wgrad", x, dy, group_ids, out_dtype)
    out = torch.empty((groups, k, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError("gmm_wgrad: the kernel's int extents need fewer "
                         "than 2**31 elements in dw")
    plan = wgrad_plan(m, k, n, groups, bm, x.dtype,
                      x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.flexagon_gmm_wgrad(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(dy.data_ptr()),
        ctypes.c_void_p(group_ids.data_ptr()), m, k, n, groups, bm,
        _DTYPES[x.dtype], _DTYPES[out_dtype], int(plan.variant == "tma"),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err:
        msg = lib.flexagon_gmm_error_string(err).decode()
        raise RuntimeError(f"gmm_wgrad: {plan.variant} kernel launch failed: "
                           f"error {err} ({msg})")
    gmm_wgrad.launches += 1
    return out


@torch.library.custom_op("repro_torch::gmm_wgrad", mutates_args=(),
                         device_types="cpu")
def _gmm_wgrad_op(x: torch.Tensor, dy: torch.Tensor, group_ids: torch.Tensor,
                  groups: int, bm: int, out_dtype: torch.dtype
                  ) -> torch.Tensor:
    return gmm_wgrad_plain(x, dy, group_ids, groups, bm=bm,
                           out_dtype=out_dtype)


_gmm_wgrad_op.register_kernel("cuda")(_k3w_launch)


@_gmm_wgrad_op.register_fake
def _(x, dy, group_ids, groups, bm, out_dtype):
    _m, k, n = _check_wgrad_shapes(x, dy, group_ids, groups, bm)
    return x.new_empty((groups, k, n), dtype=out_dtype)


@register_flop_formula(torch.ops.repro_torch.gmm_wgrad)
def _gmm_wgrad_flops(x_shape, dy_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """``2 M K N`` over the padded rows M, idle tiles included (as K3's)."""
    (m, k), n = x_shape, dy_shape[1]
    return 2 * m * k * n


def _k3w(x, dy, group_ids, groups, bm, out_dtype) -> torch.Tensor:
    """One K3w call: the plain version for a CPU tensor, one launch of the
    kernel for a CUDA tensor (``repro_torch::gmm_wgrad``)."""
    return torch.ops.repro_torch.gmm_wgrad(x, dy, group_ids, groups, bm,
                                           out_dtype)


def gmm_wgrad(x: torch.Tensor, dy: torch.Tensor, group_ids: torch.Tensor,
              groups: int, *, bm: int = 128, out_dtype=None) -> torch.Tensor:
    """The weight gradient of :func:`gmm`: ``dw[g] = sum over the row tiles
    t with group_ids[t] == g of x[t*bm:(t+1)*bm]^T @ dy[t*bm:(t+1)*bm]``,
    (G, K, N), summed in fp32, returned in ``out_dtype`` (default ``x``'s).

    A CPU tensor runs :func:`gmm_wgrad_plain`; a CUDA tensor launches the
    kernel :func:`wgrad_plan` picks, or raises.  In bf16 that is mostly
    ``wgrad_tma_kernel``: one block per group x 128 K rows x 256 N
    columns, whose producer warp streams the group's tiles in 64-row
    pieces by TMA while two warpgroups sum them with wgmma.  Other bf16
    shapes and fp32 take
    the general kernels: one block per group x 64 x 64, walking the
    group's tiles in 16-row steps.  Every variant sums in a fixed order
    with no atomics: the same inputs give the same bits on every launch.
    """
    return _k3w(x, dy, group_ids, groups, bm, out_dtype or x.dtype)


gmm_wgrad.launches = 0


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
