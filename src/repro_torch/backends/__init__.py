"""Pluggable execution backends and selection policies for the plan API.

- **backends** (:class:`ExecutionBackend`) are execution substrates —
  ``reference`` (the torch dataflow executors) and ``cuda`` (the
  hand-written Hopper kernels).  Each declares capabilities, builds
  pattern-only aux at plan time (``prepare``) and executes (``execute``);
- **policies** (:class:`SelectionPolicy`) decide *which* dataflow a plan
  uses — ``heuristic`` (analytical roofline) or a fixed pin.

``flexagon_plan(a, b, backend=..., policy=...)`` is the front door; the
registry below is how plans (which store only a backend *name*) resolve
their substrate at execution time.
"""
from .base import (  # noqa: F401
    TABLE3_FORMATS,
    BackendCapability,
    ExecutionBackend,
    allowed_dataflows,
    available_backends,
    get_backend,
    register_backend,
)
from .cuda import CudaBackend  # noqa: F401
from .policies import (  # noqa: F401
    FixedPolicy,
    HeuristicPolicy,
    SelectionContext,
    SelectionPolicy,
    get_policy,
)
from .reference import ReferenceBackend  # noqa: F401

__all__ = [
    "BackendCapability",
    "ExecutionBackend",
    "allowed_dataflows",
    "ReferenceBackend",
    "CudaBackend",
    "TABLE3_FORMATS",
    "register_backend",
    "get_backend",
    "available_backends",
    "SelectionContext",
    "SelectionPolicy",
    "HeuristicPolicy",
    "FixedPolicy",
    "get_policy",
]

# Default substrates, importable by name everywhere a plan runs.
register_backend(ReferenceBackend())
register_backend(CudaBackend())
