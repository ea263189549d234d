"""Model primitives: params are plain nested dicts of tensors; each primitive
has an ``init`` and a pure apply function, as in ``repro.models.layers``.

Init functions draw from a ``torch.Generator`` (the port's stand-in for a
JAX key); they give other numbers than JAX from the same seed, so tests
carry JAX parameters over with :func:`repro_torch.convert.lm_params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..sharding.act import grad_placed, is_dtensor, params_gathered

__all__ = ["dense_init", "dense", "rmsnorm_init", "rmsnorm", "embed_init",
           "embedding_lookup", "rope", "apply_rope", "normal"]


def normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32
           ) -> torch.Tensor:
    """``scale`` x standard normal of ``shape`` on ``gen``'s device, drawn
    in fp32 and stored as ``dtype``."""
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)
    return (out * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               dtype=torch.float32):
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    p = {"w": normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x: torch.Tensor, compute_dtype=torch.bfloat16, *,
          split_out: bool = False) -> torch.Tensor:
    """``x @ w (+ b)`` with both operands in ``compute_dtype``.
    ``split_out``: in a placed product (:func:`_dense_placed`), a d_out
    that "model" does not divide (an lm_head's vocab) is still split over
    it, padded, as GSPMD pads the reference's vocab-sharded logits."""
    w = p["w"]
    if params_gathered() and is_dtensor(x) and is_dtensor(w):
        y = _dense_placed(x, w, compute_dtype, split_out)
    else:
        y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def _dense_placed(x, w, compute_dtype, split_out=False):
    """``x @ w`` on each rank's shards, for a weight gathered over the data
    axes (``sharding.act.gathered_params``), as GSPMD places it: rows stay
    split as ``x``'s are; a weight split on d_out over a mesh dim
    (column-parallel) gives an output split on d_out there, one split on
    d_in (row-parallel) takes ``x`` split on d_in and gives the ranks'
    partial sums; a whole weight's gradient is the ranks' partial sum over
    their rows.  With ``split_out``, a weight whole on "model" gives each
    rank there its chunk of d_out (``Shard``'s uneven chunks), its
    gradient a partial sum.  DTensor's own strategy for these operands
    moves rows onto every data rank and forms whole-weight gradients on
    every rank of the other axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = w.device_mesh, x.ndim - 1
    names = mesh.mesh_dim_names or ()
    n_out, cols = w.shape[1], slice(None)
    x_pl, out_pl, x_grad, w_grad = [], [], [], []
    for d, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        rows = xp if isinstance(xp, Shard) and xp.dim % x.ndim != last \
            else Replicate()
        if wp == Shard(1):               # column-parallel
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
            x_grad.append(Partial())
            w_grad.append(wp)
        elif wp == Shard(0):             # row-parallel
            x_pl.append(Shard(last))
            out_pl.append(Partial())
            x_grad.append(Shard(last))
            w_grad.append(wp)
        elif split_out and names[d] == "model" and mesh.size(d) > 1:
            chunk = -(-n_out // mesh.size(d))
            lo = min(mesh.get_local_rank(d) * chunk, n_out)
            cols = slice(lo, min(lo + chunk, n_out))
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
            x_grad.append(Partial())
            w_grad.append(Partial())
        else:
            x_pl.append(rows)
            out_pl.append(rows)
            x_grad.append(rows)
            w_grad.append(Partial() if isinstance(rows, Shard)
                          else Replicate())
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad)
    wl = w.to_local(grad_placements=w_grad)[:, cols]
    y = torch.matmul(xl.to(compute_dtype), wl.to(compute_dtype))
    shape = x.shape[:-1] + (n_out,)
    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    return DTensor.from_local(y, mesh, out_pl, run_check=False, shape=shape,
                              stride=stride)


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    return {"table": normal(gen, (vocab, d), 0.02, dtype)}


def embedding_lookup(p, ids: torch.Tensor, compute_dtype=torch.bfloat16
                     ) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first,
    # without a full-table copy per call
    table = p["table"]
    if is_dtensor(table):
        return _sharded_lookup(table, ids, compute_dtype)
    return table[ids].to(compute_dtype)


def _sharded_lookup(table, ids, compute_dtype):
    """The lookup on a DTensor table, each rank on its own shard
    (``local_map``), the table staying as it is placed: over a mesh dim
    that shards ``d`` the ids are gathered (they are small) and the output
    is sharded along ``d``; over one that shards the vocab each rank
    gathers the ids that fall in its rows and zeros for the rest, and the
    output is the ranks' partial sum; elsewhere the ids keep their batch
    shards.  DTensor's own indexing differentiates into an ``index_put``
    whose sharding rule fails in some torch versions, and its
    ``embedding`` rule's masked partial does not take these ids.  The
    table's gradient from this use comes back in the table's placements
    (a tied table has a second use)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    table = grad_placed(table)
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    d_dim = ids.dim()                     # the output's d dim
    t_pl = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate()
                 for pl in table.placements)
    vocab = [i for i, pl in enumerate(t_pl) if pl == Shard(0)]
    given = ids.placements if is_dtensor(ids) else (Replicate(),) * mesh.ndim
    id_pl = tuple(pl if pl == Shard(0) and t_pl[i] == Replicate()
                  else Replicate() for i, pl in enumerate(given))
    t_grad = tuple(t_pl[i] if t_pl[i] != Replicate() else Partial()
                   if id_pl[i] == Shard(0) else Replicate()
                   for i in range(mesh.ndim))
    out_pl = tuple(Partial() if t_pl[i] == Shard(0)
                   else Shard(d_dim) if t_pl[i] == Shard(1) else id_pl[i]
                   for i in range(mesh.ndim))

    def lookup(tbl, idx):
        if not vocab:
            return tbl[idx].to(compute_dtype)
        n = tbl.shape[0]
        lo = n * sum(mesh.get_local_rank(names[i]) * math.prod(
            mesh.size(j) for j in vocab if j > i) for i in vocab)
        hit = (idx >= lo) & (idx < lo + n)
        rows = tbl[torch.where(hit, idx - lo, 0)]
        return (rows * hit[..., None].to(rows.dtype)).to(compute_dtype)

    fn = local_map(lookup, out_placements=(out_pl,),
                   in_placements=(t_pl, id_pl),
                   in_grad_placements=(t_grad, id_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, ids)


def rope(positions: torch.Tensor, d_head: int, theta: float = 1e4):
    """Rotary position embedding angles.  positions: (..., S) integer."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (S, Dh/2) or (B, S, Dh/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:                     # (S, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
