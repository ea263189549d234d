"""Static-analysis layer: plan verifier, schedule checker, dispatch report,
AST lint — the port of ``repro.analysis``.

Attribute access is lazy (PEP 562) so the stdlib-only lint CLI
(``python -m repro_torch.analysis.lint``) never pays for a torch import
through the verifier or the dispatch report.
"""
from __future__ import annotations

from .diagnostics import (ERROR, INFO, WARNING, PlanDiagnostic,
                          PlanVerificationError, errors_of)

__all__ = [
    "ERROR",
    "WARNING",
    "INFO",
    "PlanDiagnostic",
    "PlanVerificationError",
    "errors_of",
    "verify_plan",
    "verify_cache",
    "trace_report",
    "TraceReport",
    "RetraceDetector",
    "Observation",
    "check_schedule",
    "check_device_schedule",
    "check_stack_uniform",
    "lint_paths",
]

_LAZY = {
    "verify_plan": "verify",
    "verify_cache": "verify",
    "trace_report": "dispatch",
    "TraceReport": "dispatch",
    "RetraceDetector": "dispatch",
    "Observation": "dispatch",
    "check_schedule": "schedule",
    "check_device_schedule": "schedule",
    "check_stack_uniform": "schedule",
    "lint_paths": "lint",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
