"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B; unverified tier].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256 — small llama3 with
the 500k rope base.
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=128256,
        rope_theta=5e5,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_head=16,
        d_ff=256,
        vocab=256,
        tie_embeddings=True,
    ),
)
