"""Sharding of params, batches, caches and activations over a
``DeviceMesh`` ("pod", "data", "model"), as DTensor placements: the port
of ``repro.sharding``."""
from .act import dp_axes, shard, use_mesh  # noqa: F401
from .rules import (  # noqa: F401
    DATA_AXES, NamedSharding, abstract_like, batch_sharding, cache_sharding,
    distribute, params_sharding,
)
