"""Architecture registry of the port: one module per arch, copies of the
JAX package's.

``get_config(name)`` returns the exact published config; ``get_config(name,
smoke=True)`` returns the reduced same-family config used by CPU tests.
All ten archs of ``repro.configs`` are registered, in its order.
"""
from .base import (  # noqa: F401
    ModelConfig, MoEConfig, LayerPattern, REGISTRY, SHAPES, ShapeSpec,
    get_config,
)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        granite_moe_1b_a400m, mixtral_8x7b, jamba_v0_1_52b, smollm_360m,
        qwen2_1_5b, granite_34b, llama3_2_3b, rwkv6_3b, chameleon_34b,
        seamless_m4t_large_v2,
    )
    _LOADED = True


ARCH_IDS = [
    "granite-moe-1b-a400m", "mixtral-8x7b", "jamba-v0.1-52b", "smollm-360m",
    "qwen2-1.5b", "granite-34b", "llama3.2-3b", "rwkv6-3b", "chameleon-34b",
    "seamless-m4t-large-v2",
]
