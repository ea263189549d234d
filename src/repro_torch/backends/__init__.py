"""Pluggable execution backends and selection policies for the plan API.

- **backends** (:class:`ExecutionBackend`) are execution substrates —
  ``reference`` (the torch dataflow executors), ``cuda`` (the
  hand-written Hopper kernels) and ``simulator`` (cycle-level cost oracle
  + reference-validated execution).  Each declares capabilities, builds
  pattern-only aux at plan time (``prepare``), executes (``execute``) and
  prices (shape, dataflow) pairs (``cost``);
- **policies** (:class:`SelectionPolicy`) decide *which* dataflow a plan
  uses — ``heuristic`` (analytical roofline), ``simulator`` (simulated
  cycles, the paper's phase 1 proper), ``autotune`` (measured on the
  device, cached by pattern fingerprint), or a fixed pin.

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
    AutotunePolicy,
    FixedPolicy,
    HeuristicPolicy,
    SelectionContext,
    SelectionPolicy,
    SimulatorPolicy,
    get_policy,
)
from .reference import ReferenceBackend  # noqa: F401
from .simulator import SimulatorBackend  # noqa: F401

__all__ = [
    "BackendCapability",
    "ExecutionBackend",
    "allowed_dataflows",
    "ReferenceBackend",
    "CudaBackend",
    "SimulatorBackend",
    "TABLE3_FORMATS",
    "register_backend",
    "get_backend",
    "available_backends",
    "SelectionContext",
    "SelectionPolicy",
    "HeuristicPolicy",
    "SimulatorPolicy",
    "AutotunePolicy",
    "FixedPolicy",
    "get_policy",
]

# Default substrates, importable by name everywhere a plan runs.
register_backend(ReferenceBackend())
register_backend(CudaBackend())
register_backend(SimulatorBackend())
