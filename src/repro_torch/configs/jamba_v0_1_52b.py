"""jamba-v0.1-52b [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, hybrid Mamba+attention
at a 1:7 ratio (one attention layer per 8-layer period), MoE 16e top-2 on
every other layer.  The Mamba layers make long_500k an O(1)-state decode for
7/8 of the stack.
"""
from .base import LayerPattern, ModelConfig, MoEConfig, register

_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
           "mamba")

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=65536,
        pattern=LayerPattern(mixers=_PERIOD),
        moe=MoEConfig(num_experts=16, top_k=2, pattern="odd",
                      strategy="einsum"),
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
    ),
    smoke=ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=96,
        vocab=256,
        pattern=LayerPattern(mixers=_PERIOD),
        moe=MoEConfig(num_experts=4, top_k=2, pattern="odd",
                      strategy="einsum", capacity_factor=2.0),
        mamba_d_state=4,
        mamba_d_conv=2,
        mamba_expand=2,
    ),
)
