"""seamless-m4t-large-v2 [arXiv:2308.11596].

Encoder-decoder, 24L total (12 speech-encoder + 12 text-decoder layers under
the assigned 24L budget — see DESIGN.md), d_model=1024 16H (kv=16 = MHA)
d_ff=8192 vocab=256206.  The audio frontend is a STUB: ``input_specs``
provides precomputed frame embeddings (B, S_enc, d_model).

long_500k is skipped for this arch (full-attention encoder-decoder speech
model; 500k-token decode is out of scope for its task — DESIGN.md §6).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        kind="encdec",
        n_layers=24,
        n_encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=8192,
        vocab=256206,
        frontend="frames",
    ),
    smoke=ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        kind="encdec",
        n_layers=4,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        frontend="frames",
    ),
)
