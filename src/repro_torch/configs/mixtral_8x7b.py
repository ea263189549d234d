"""mixtral-8x7b [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding-window attention (window 4096).  SWA gives a constant-size KV ring
buffer, which is what makes the long_500k decode cell feasible.
"""
from .base import LayerPattern, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=32000,
        pattern=LayerPattern(mixers=("swa",)),
        swa_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, pattern="all",
                      strategy="einsum"),
        rope_theta=1e6,
    ),
    smoke=ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=96,
        vocab=256,
        pattern=LayerPattern(mixers=("swa",)),
        swa_window=16,
        moe=MoEConfig(num_experts=4, top_k=2, pattern="all",
                      strategy="einsum", capacity_factor=2.0),
    ),
)
