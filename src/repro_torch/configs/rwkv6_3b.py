"""rwkv6-3b ("Finch") [arXiv:2404.05892].

32L d_model=2560 (attention-free, 40 heads × 64) d_ff=8960 vocab=65536 —
data-dependent decay linear recurrence; decode state is O(1) in context
length, so every decode shape (incl. long_500k) runs with constant memory.

Arch-applicability note (DESIGN.md): the SpMSpM technique does not apply to
the dense recurrence; the arch is implemented without it.
"""
from .base import LayerPattern, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        d_head=64,
        d_ff=8960,
        vocab=65536,
        pattern=LayerPattern(mixers=("rwkv",)),
        rwkv_head_dim=64,
    ),
    smoke=ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        pattern=LayerPattern(mixers=("rwkv",)),
        rwkv_head_dim=16,
    ),
)
