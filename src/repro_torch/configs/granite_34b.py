"""granite-34b [arXiv:2405.04324].

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — deep code model;
MQA means a single shared KV head (the KV cache is 48× smaller than MHA).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab=49152,
    ),
    smoke=ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=3,
        d_model=96,
        n_heads=6,
        n_kv_heads=1,
        d_head=16,
        d_ff=192,
        vocab=256,
    ),
)
