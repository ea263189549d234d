"""Typed diagnostics for the static-analysis layer.

Every analysis pass — the plan verifier, the dispatch trace report,
the AST lint — reports findings as :class:`PlanDiagnostic`\\ s: a stable
``code`` (what invariant broke), a ``severity``, a human message, a
``location`` inside the plan (e.g. ``plan.plans[3].index_plan``), and a
``hint`` that tells the reader how to reproduce or fix it.  Codes are part
of the contract, and the same as the JAX package's: the mutation tests in
``tests/test_torch_analysis.py`` assert that each seeded corruption
surfaces *its* code, so renaming one is an API change.

Severities:

- ``error``   — the plan would compute wrong results, crash, or silently
  fall back; ``verify_plan(raise_on_error=True)`` raises on these;
- ``warning`` — suspicious but not provably wrong (e.g. trace FLOP count
  disagreeing with the traffic model by more than 2×);
- ``info``    — observations (e.g. a mesh smaller than the shard count, so
  ``apply`` takes the serial path).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = [
    "ERROR",
    "WARNING",
    "INFO",
    "PlanDiagnostic",
    "PlanVerificationError",
]

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class PlanDiagnostic:
    """One verifier/analysis finding.

    ``code`` is a stable kebab-case identifier (``tile-overlap``,
    ``pad-inbounds``, ``backend-capability`` …) — test against codes, not
    message text.
    """

    code: str
    severity: str
    message: str
    location: str = "plan"
    hint: Optional[str] = None

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self) -> str:
        hint = f"  (hint: {self.hint})" if self.hint else ""
        return f"[{self.severity}] {self.location}: {self.code}: " \
               f"{self.message}{hint}"


class PlanVerificationError(ValueError):
    """Raised by ``verify_plan(raise_on_error=True)`` on error-severity
    diagnostics.  Carries the full diagnostic list (``.diagnostics``)."""

    def __init__(self, diagnostics: List[PlanDiagnostic]):
        self.diagnostics = tuple(diagnostics)
        errors = [d for d in diagnostics if d.is_error]
        lines = "\n".join(f"  {d}" for d in errors)
        super().__init__(
            f"plan verification failed with {len(errors)} error(s):\n{lines}")


def errors_of(diagnostics: List[PlanDiagnostic]) -> Tuple[PlanDiagnostic, ...]:
    """The error-severity subset (the gate condition)."""
    return tuple(d for d in diagnostics if d.is_error)
