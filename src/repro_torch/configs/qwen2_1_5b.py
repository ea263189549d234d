"""qwen2-1.5b [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 — QKV bias, tied
embeddings, very large vocabulary (vocab-sharded lm head matters here).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
    ),
    smoke=ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        tie_embeddings=True,
    ),
)
