"""Cycle-level accelerator models (paper §4–5 evaluation substrate)."""
from .config import AcceleratorConfig, PAPER_CONFIG          # noqa: F401
from .stats import LayerSpec, LayerStats, from_layer, from_masks  # noqa: F401
from .accelerators import (                                   # noqa: F401
    SimResult, simulate, simulate_ip, simulate_op, simulate_gust,
    simulate_flexagon, ACCELERATORS,
)
from .area import (                                            # noqa: F401
    accelerator_area, accelerator_power, naive_design_area, perf_per_area,
    COMPONENT_AREA_MM2, COMPONENT_POWER_MW,
)
