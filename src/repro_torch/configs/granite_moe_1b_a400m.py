"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
The paper's technique is directly applicable: MoE dispatch runs the
three-dataflow selectable path (32 experts, fine-grained).

The published model also scales its embedding (x12), its attention scores
(0.015625 in place of 1/sqrt(64)), each residual branch (x0.22) and its
logits (/6), and takes RMSNorm's epsilon as 1e-6: the full config carries
them (``scales``, the port's own field).  The smoke config keeps the JAX
package's, so the CPU tests against it compare the shared code.
"""
from .base import ModelConfig, MoEConfig, Scales, register

CONFIG = register(
    ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=64,
        d_ff=512,
        vocab=49155,
        moe=MoEConfig(num_experts=32, top_k=8, pattern="all",
                      strategy="einsum"),
        tie_embeddings=True,
        norm_eps=1e-6,
        scales=Scales(embedding=12.0, attention=0.015625, residual=0.22,
                      logits=6.0),
    ),
    smoke=ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=32,
        vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, pattern="all",
                      strategy="einsum", capacity_factor=2.0),
        tie_embeddings=True,
    ),
)
