"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 — llama-arch small.
15 heads deliberately exercises uneven TP sharding (GSPMD pads 15 over the
16-way model axis).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_head=64,
        d_ff=2560,
        vocab=49152,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=3,
        n_kv_heads=1,
        d_head=32,
        d_ff=256,
        vocab=256,
        tie_embeddings=True,
    ),
)
