"""Architecture registry of the port: one module per ported arch.

``get_config(name)`` returns the exact published config; ``get_config(name,
smoke=True)`` returns the reduced same-family config used by CPU tests.
Only the archs whose modules the port runs are registered: the MoE decoder
granite-moe-1b-a400m and the dense decoders qwen2-1.5b and smollm-360m.
"""
from .base import (  # noqa: F401
    ModelConfig, MoEConfig, LayerPattern, REGISTRY, get_config,
)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import granite_moe_1b_a400m, qwen2_1_5b, smollm_360m  # noqa: F401
    _LOADED = True


ARCH_IDS = ["granite-moe-1b-a400m", "qwen2-1.5b", "smollm-360m"]
