"""Abstract inputs and step functions for every (arch x shape) cell.

The port of ``repro.launch.specs``.  A :class:`Cell` holds meta tensors
(shapes and dtypes, no storage) for every input of one step, each leaf's
:class:`~repro_torch.sharding.NamedSharding` on the production mesh, and
the function the dry-run runs:

- ``train_*``   -> ``train_step(state, batch)`` (params, the AdamW state
  ``m``, ``v``, ``step`` and, under compression, ``ef``);
- ``prefill_*`` -> ``model.prefill(params, tokens or {frames, tokens},
  cache)``;
- ``decode_*`` / ``long_*`` -> ``model.decode_step(params, cache, tokens)``:
  one new token against a cache of the shape's ``seq_len``.

The audio frontend is a stub, as in the reference: seamless gets
precomputed frame embeddings.  Building a cell allocates nothing and
starts no process group; the mesh it is given must already exist
(:func:`repro_torch.launch.mesh.make_production_mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from ..configs import get_config
from ..configs.base import SHAPES, ShapeSpec, TrainConfig
from ..models import build_model
from ..sharding import (NamedSharding, batch_sharding, cache_sharding,
                        params_sharding)
from ..train import init_train_state, make_train_step
from ..train.optimizer import AdamWState
from ..train.trainer import TrainState

__all__ = ["SKIPS", "TRAIN_MICROBATCHES", "VARIANTS", "Cell",
           "cell_is_supported", "build_cell", "meta_model_init"]

#: shapes each arch skips, with the reason
SKIPS: Dict[Tuple[str, str], str] = {
    ("seamless-m4t-large-v2", "long_500k"):
        "full-attention encoder-decoder speech model; 500k-token decode is "
        "out of scope for its task (DESIGN.md §6)",
}


def cell_is_supported(arch: str, shape: str) -> Optional[str]:
    """None if supported, else the skip reason."""
    return SKIPS.get((arch, shape))


#: gradient-accumulation depth for train_4k per arch (activation-memory
#: knob; larger models need smaller microbatches to fit a device)
TRAIN_MICROBATCHES = {
    "jamba-v0.1-52b": 32,
    "mixtral-8x7b": 16,
    "granite-34b": 32,
    "chameleon-34b": 16,
    "seamless-m4t-large-v2": 32,
}


# --- variants: (config transform, TrainConfig overrides) ---

def _v_cp(cfg):
    return dataclasses.replace(cfg, context_parallel=True)


def _v_moe(strategy):
    def f(cfg):
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, strategy=strategy))
    return f


VARIANTS = {
    "baseline": (lambda cfg: cfg, {}),
    "cp": (_v_cp, {}),                # context-parallel activations
    "moe_sort": (_v_moe("sort"), {}),
    "moe_scatter": (_v_moe("scatter"), {}),
    "bf16_params": (lambda cfg: cfg, {"param_dtype": "bfloat16"}),
    "remat_dots": (lambda cfg: cfg, {"remat": "dots"}),
    "bf16_dots": (lambda cfg: cfg, {"param_dtype": "bfloat16",
                                    "remat": "dots"}),
    "cp_bf16": (_v_cp, {"param_dtype": "bfloat16"}),
}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Any                     # the function to run
    args: Tuple[Any, ...]       # trees of meta tensors
    in_shardings: Tuple[Any, ...]
    static_desc: Dict[str, Any]


class _OnMeta(TorchFunctionMode):
    """Every tensor a factory call makes lands on the meta device; a
    generator argument is dropped (the meta device draws no numbers)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs or "generator" in kwargs:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def meta_model_init(cfg, init, *args, **kwargs):
    """``init(model, *args, **kwargs)`` for ``cfg``'s model with every
    tensor on the meta device: the port's ``jax.eval_shape`` of an init.

    The init runs on a CPU model (a meta device has no generator) whose
    factory calls are sent to the meta device."""
    model = build_model(cfg, device="cpu")
    with _OnMeta():
        return init(model, *args, **kwargs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg, shape: ShapeSpec):
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32),
             "targets": _meta((b, s), torch.int32)}
    if cfg.frontend == "frames":
        batch["frames"] = _meta((b, max(1, s // 4), cfg.d_model),
                                torch.bfloat16)
    return batch


def _train_cell(cfg, shape: ShapeSpec, mesh, *, microbatches: int,
                tcfg_over=None) -> Cell:
    model = build_model(cfg, device="meta")
    tcfg = TrainConfig(global_batch=shape.global_batch, seq_len=shape.seq_len,
                       microbatches=microbatches, **(tcfg_over or {}))
    state = meta_model_init(cfg, init_train_state, 0, tcfg)
    batch = _token_batch(cfg, shape)
    state_shard = TrainState(
        params=params_sharding(state.params, mesh, cfg),
        opt=AdamWState(step=NamedSharding(mesh, ()),
                       m=params_sharding(state.opt.m, mesh, cfg),
                       v=params_sharding(state.opt.v, mesh, cfg)),
        ef=None if state.ef is None
        else params_sharding(state.ef, mesh, cfg),
    )
    step = make_train_step(model, tcfg)
    return Cell(cfg.name, shape, step, (state, batch),
                (state_shard, batch_sharding(batch, mesh)),
                {"kind": "train", "microbatches": microbatches,
                 "donate": (0,)})


def _serve_structs(cfg, shape: ShapeSpec):
    model = build_model(cfg, device="meta")
    params = meta_model_init(cfg, lambda m: m.init(0))
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    return model, params, cache


def _prefill_cell(cfg, shape: ShapeSpec, mesh) -> Cell:
    model, params, cache = _serve_structs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if cfg.kind == "encdec":
        inputs = {"frames": _meta((b, max(1, s // 4), cfg.d_model),
                                  torch.bfloat16),
                  "tokens": _meta((b, 1), torch.int32)}
        in_sh = batch_sharding(inputs, mesh)
    else:
        inputs = _meta((b, s), torch.int32)
        in_sh = batch_sharding({"tokens": inputs}, mesh)["tokens"]
    return Cell(cfg.name, shape, model.prefill, (params, inputs, cache),
                (params_sharding(params, mesh, cfg), in_sh,
                 cache_sharding(cache, mesh, cfg)),
                {"kind": "prefill", "donate": (2,)})


def _decode_cell(cfg, shape: ShapeSpec, mesh) -> Cell:
    model, params, cache = _serve_structs(cfg, shape)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    return Cell(cfg.name, shape, model.decode_step, (params, cache, tokens),
                (params_sharding(params, mesh, cfg),
                 cache_sharding(cache, mesh, cfg),
                 batch_sharding({"tokens": tokens}, mesh)["tokens"]),
                {"kind": "decode", "donate": (1,)})


def build_cell(arch: str, shape_name: str, mesh, *,
               microbatches: Optional[int] = None,
               variant: str = "baseline") -> Cell:
    cfg_fn, tcfg_over = VARIANTS[variant]
    cfg = cfg_fn(get_config(arch))
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, 8)
        return _train_cell(cfg, shape, mesh, microbatches=mb,
                           tcfg_over=tcfg_over)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, shape, mesh)
    if shape.kind == "decode":
        return _decode_cell(cfg, shape, mesh)
    raise ValueError(shape.kind)
