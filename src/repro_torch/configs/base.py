"""Config system: model architecture knobs, copied from the JAX package.

Every ported architecture is one :class:`ModelConfig` instance in
``configs/<id>.py`` (exact, from the public literature) plus a reduced
``SMOKE`` variant of the same family for CPU tests.  The dataclasses are
field-for-field copies of ``repro.configs.base``, so a config means the same
model in both packages, but for one field of the port's own:
``ModelConfig.scales`` (:class:`Scales`), the muP scalars some published
models multiply their embedding, attention scores, residual branches and
logits by, which the JAX package's config does not carry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["ModelConfig", "MoEConfig", "LayerPattern", "Scales",
           "TrainConfig",
           "SHAPES", "ShapeSpec", "REGISTRY", "register", "get_config"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    #: dispatch dataflow: "einsum" (IP-analogue, capacity-based),
    #: "scatter" (OP-analogue, dense compute + weighted merge),
    #: "sort" (Gust-analogue, token grouping + grouped GEMM), or "auto"
    #: (cost-model selection per layer shape — the paper's phase 1).
    strategy: str = "auto"
    capacity_factor: float = 1.25
    #: which layers are MoE: "all", "even", "odd", "none"
    pattern: str = "all"
    #: expert-parallel stationarity (the paper's M/N-stationary notion
    #: applied to EP): "tokens" keeps tokens local and replicates expert
    #: weights over DP (wins for fine-grained experts); "weights" shards
    #: experts over the data axis and moves tokens (wins for huge experts);
    #: "auto" compares weight bytes vs dispatch payload per layer.
    ep_layout: str = "auto"


@dataclasses.dataclass(frozen=True)
class LayerPattern:
    """Heterogeneous layer stacking (hybrid archs).

    ``mixers`` is one period of per-layer sequence-mixer kinds; it tiles to
    ``n_layers``.  Kinds: "attn", "swa" (sliding window), "mamba", "rwkv".
    """

    mixers: Tuple[str, ...] = ("attn",)

    def mixer_for_layer(self, i: int) -> str:
        return self.mixers[i % len(self.mixers)]


@dataclasses.dataclass(frozen=True)
class Scales:
    """The muP scalars of a published model (granite's ``config.json``:
    ``embedding_multiplier``, ``attention_multiplier``,
    ``residual_multiplier``, ``logits_scaling``).

    The embedding's output is multiplied by ``embedding``; attention's
    softmax takes its scores times ``attention`` (in place of
    1/sqrt(head_dim)); each residual branch is multiplied by ``residual``
    before it is added; the logits are divided by ``logits``."""

    embedding: float = 1.0
    attention: Optional[float] = None
    residual: float = 1.0
    logits: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: Optional[int] = None
    d_head: Optional[int] = None
    kind: str = "decoder"            # decoder | encdec
    n_encoder_layers: int = 0        # encdec only
    pattern: LayerPattern = LayerPattern()
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    qk_norm: bool = False            # chameleon
    swa_window: int = 4096
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # SSM / RWKV geometry
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    # frontend: "tokens" | "frames" (audio stub) — vlm uses tokens (VQ ids)
    frontend: str = "tokens"
    # weight-sparse FFN (the paper's technique on dense layers; optional)
    ffn_block_sparsity: float = 0.0
    # compute dtype
    dtype: str = "bfloat16"
    #: context/sequence parallelism: shard activations' sequence dim over
    #: the "model" axis (beyond-paper optimization; see EXPERIMENTS §Perf)
    context_parallel: bool = False
    #: the port's own field (the JAX config has none): the model's muP
    #: scalars, or None for none (every product as the JAX package has it)
    scales: Optional[Scales] = None

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def mixer_for_layer(self, i: int) -> str:
        return self.pattern.mixer_for_layer(i)

    def ffn_for_layer(self, i: int) -> str:
        if self.moe is None or self.moe.pattern == "none":
            return "dense"
        p = self.moe.pattern
        if p == "all":
            return "moe"
        if p == "even":
            return "moe" if i % 2 == 0 else "dense"
        if p == "odd":
            return "moe" if i % 2 == 1 else "dense"
        raise ValueError(p)

    def layer_signature(self, i: int) -> Tuple[str, str]:
        return (self.mixer_for_layer(i), self.ffn_for_layer(i))

    def segments(self) -> List[Tuple[Tuple[Tuple[str, str], ...], int]]:
        """Partition layers into (super-block signature, repeat count) runs.

        A homogeneous stack is one segment of period 1 repeated n_layers
        times (scanned).  Hybrids (e.g. Jamba's 1:7 attn:mamba + alternating
        MoE) tile a longer period; the period becomes the scan body.
        """
        sigs = [self.layer_signature(i) for i in range(self.n_layers)]
        # find the smallest period that tiles the whole stack
        for period in range(1, self.n_layers + 1):
            if self.n_layers % period:
                continue
            if all(sigs[i] == sigs[i % period] for i in range(self.n_layers)):
                return [(tuple(sigs[:period]), self.n_layers // period)]
        return [(tuple(sigs), 1)]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    #: activation checkpointing: True/"nothing" (recompute everything),
    #: "dots" (save matmul outputs — less recompute, more live memory),
    #: False (no remat)
    remat: object = True
    #: int8 gradient compression for the DP all-reduce (with error feedback)
    grad_compression: bool = False
    #: parameter storage dtype ("float32" master weights, or "bfloat16" with
    #: fp32 optimizer moments — halves param/grad memory and traffic)
    param_dtype: str = "float32"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

REGISTRY: Dict[str, "ModelConfig"] = {}
_SMOKE: Dict[str, "ModelConfig"] = {}


def register(config: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    REGISTRY[config.name] = config
    _SMOKE[config.name] = smoke
    return config


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    from . import _load_all  # noqa: F401  (populate registry)
    _load_all()
    return (_SMOKE if smoke else REGISTRY)[name]
