"""Carry values from the JAX package's structures into the port's.

The port never imports the JAX package; these functions read any objects
with the JAX structures' fields and turn each array into numpy first, so
JAX arrays, numpy arrays and tensors all work.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .api import SparseOperand
from .config import resolve_device
from .core.formats import SparseFormat

__all__ = ["encdec_params_from_jax", "ffn_params_from_jax",
           "lm_params_from_jax", "sparse_operand_from_jax",
           "train_state_from_jax"]


def _tensor(x, device) -> torch.Tensor:
    if device.type == "meta":
        # shapes and dtypes only: an abstract leaf (jax.eval_shape's
        # ShapeDtypeStruct) is enough, and no value is read
        return torch.empty(tuple(x.shape), device=device,
                           dtype=getattr(torch, np.dtype(x.dtype).name))
    return torch.as_tensor(np.array(x), device=device)


def ffn_params_from_jax(tree: Dict[str, Any], *, device=None
                        ) -> Dict[str, Any]:
    """JAX FFN params -> the port's, as tensors on ``device``.

    ``tree`` is ``{"w_gate": {"w"}, "w_up": {"w"}, "w_down": {"w"}}`` plus
    an optional ``"block_mask"``, as the JAX package's ``ffn_init`` makes
    it; ``device=None`` resolves to the card.
    """
    dev = resolve_device(device)
    out: Dict[str, Any] = {name: {"w": _tensor(tree[name]["w"], dev)}
                           for name in ("w_gate", "w_up", "w_down")}
    if "block_mask" in tree:
        out["block_mask"] = _tensor(tree["block_mask"], dev)
    return out


def sparse_operand_from_jax(op, *, device=None) -> SparseOperand:
    """A JAX ``SparseOperand`` -> the port's.

    Block data lands on ``device`` (``None``: the card); the coordinate
    arrays stay on the host, as the port keeps them.  Scalar formats stay
    numpy throughout.
    """
    fmt = SparseFormat.of(getattr(op.fmt, "value", op.fmt))
    data = np.array(op.data)
    if fmt.is_block:
        data = torch.as_tensor(data, device=resolve_device(device))
    return SparseOperand(
        data, np.array(op.indptr), np.array(op.indices), tuple(op.shape),
        tuple(op.block_shape) if op.block_shape is not None else None, fmt)


def _tree(x, dev):
    if isinstance(x, dict):
        return {k: _tree(v, dev) for k, v in x.items()}
    return _tensor(x, dev)


def lm_params_from_jax(tree: Dict[str, Any], cfg, *, device=None
                       ) -> Dict[str, Any]:
    """JAX ``LM.init`` params -> the port's, as tensors on ``device``.

    The JAX stack keeps one entry per segment, each a list over the
    segment's period of block dicts whose leaves are stacked along a leading
    repeat axis; layer ``r * len(period) + j`` of a segment is repeat ``r``
    of period position ``j``.  The port keeps one block dict per layer, in
    layer order.  A hybrid period (jamba: 8 layers, repeated 4 times at
    full depth) and rwkv's block (its channel-mix params inside
    ``mixer``) unstack the same way.  ``device=None`` resolves to the card;
    ``device="meta"`` gives the port's skeleton of an abstract tree
    (``jax.eval_shape(model.init, key)``) at any width.
    """
    dev = resolve_device(device)
    blocks = []
    for seg, (period, count) in zip(tree["blocks"], cfg.segments()):
        stacked = [_tree(p, dev) for p in seg]
        for r in range(count):
            for j in range(len(period)):
                blocks.append(_index(stacked[j], r))
    out = {name: _tree(tree[name], dev)
           for name in ("embed", "final_norm", "lm_head") if name in tree}
    out["blocks"] = blocks
    return out


def _index(x, r):
    if isinstance(x, dict):
        return {k: _index(v, r) for k, v in x.items()}
    return x[r]


def encdec_params_from_jax(tree: Dict[str, Any], cfg, *, device=None
                           ) -> Dict[str, Any]:
    """JAX ``EncDec.init`` params -> the port's, as tensors on ``device``.

    JAX stacks ``encoder`` and ``decoder`` along a leading layer axis; the
    port keeps a list with one layer dict each, in layer order.
    ``device=None`` resolves to the card.
    """
    dev = resolve_device(device)
    out = {name: _tree(value, dev) for name, value in tree.items()
           if name not in ("encoder", "decoder")}
    for name, n in (("encoder", cfg.n_encoder_layers),
                    ("decoder", cfg.n_layers - cfg.n_encoder_layers)):
        stacked = _tree(tree[name], dev)
        out[name] = [_index(stacked, r) for r in range(n)]
    return out


def train_state_from_jax(state, cfg, *, device=None):
    """A JAX ``TrainState`` -> the port's, on ``device`` (``None``: the card).

    The params, the AdamW moments ``m`` and ``v`` and the error-feedback
    residuals ``ef`` (when present) are unstacked as
    :func:`lm_params_from_jax` / :func:`encdec_params_from_jax` unstack
    params; ``step`` becomes a 0-d int32 tensor.
    """
    from .train.optimizer import AdamWState
    from .train.trainer import TrainState

    dev = resolve_device(device)
    tree = (encdec_params_from_jax if cfg.kind == "encdec"
            else lm_params_from_jax)

    def conv(t):
        return None if t is None else tree(t, cfg, device=dev)

    opt = AdamWState(step=_tensor(state.opt.step, dev).to(torch.int32),
                     m=conv(state.opt.m), v=conv(state.opt.v))
    return TrainState(params=conv(state.params), opt=opt, ef=conv(state.ef))
