"""Fault-tolerance hooks of the port."""
from .fault_tolerance import (  # noqa: F401
    HeartbeatMonitor, StragglerPolicy, WorkerFailure, elastic_mesh_shape,
    run_with_recovery,
)
