"""chameleon-34b [arXiv:2405.09818; unverified tier].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 — early-fusion VLM:
text and VQ-VAE image tokens share one vocabulary, the backbone is a plain
decoder with QK-norm (Chameleon's divergence fix).  The modality frontend is
a stub per the assignment: ``input_specs`` provides token ids that already
include image tokens.
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=22016,
        vocab=65536,
        qk_norm=True,
    ),
    smoke=ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        qk_norm=True,
    ),
)
