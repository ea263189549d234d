"""The ``ExecutionBackend`` protocol and backend registry.

The paper's phase 1 is "estimate every dataflow's cost, pick one, configure
the hardware".  This module is the seam that keeps both halves swappable:

- an :class:`ExecutionBackend` is one *execution substrate* for planned
  SpMSpM — it declares what it can run (:class:`BackendCapability`), builds
  pattern-only auxiliary schedules at plan time (:meth:`ExecutionBackend.
  prepare` — the "configure the hardware" step), executes a plan
  (:meth:`ExecutionBackend.execute`), and prices a (shape, dataflow) pair
  (:meth:`ExecutionBackend.cost` — the oracle that selection policies
  consult);
- the registry maps backend names to live instances so a
  :class:`repro_torch.api.FlexagonPlan` carries only a *name* and resolves
  the substrate at execution time.

Three backends ship by default (registered in
:mod:`repro_torch.backends`): ``reference`` (the torch dataflow executors),
``cuda`` (the hand-written kernels) and ``simulator`` (the cycle-level cost
oracle, executing through the reference executors).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..core.dataflows import DATAFLOWS
from ..core.formats import SparseFormat
from ..core.selector import DeviceSpec, LayerShape, estimate

__all__ = [
    "TABLE3_FORMATS",
    "BackendCapability",
    "ExecutionBackend",
    "allowed_dataflows",
    "register_backend",
    "get_backend",
    "available_backends",
]

#: Table 3 operand formats per dataflow: (A format, B format).
TABLE3_FORMATS = {
    "ip_m": (SparseFormat.BCSR, SparseFormat.BCSC),
    "op_m": (SparseFormat.BCSC, SparseFormat.BCSR),
    "gust_m": (SparseFormat.BCSR, SparseFormat.BCSR),
    "ip_n": (SparseFormat.BCSR, SparseFormat.BCSC),
    "op_n": (SparseFormat.BCSC, SparseFormat.BCSR),
    "gust_n": (SparseFormat.BCSC, SparseFormat.BCSC),
}


@dataclasses.dataclass(frozen=True)
class BackendCapability:
    """What one backend can run — consulted during phase-1 negotiation.

    ``dataflows``      — dataflow names the backend executes.
    ``formats``        — (A, B) operand-format pairs it ingests.
    ``block_multiple`` — block dims must be multiples of this (1 = any).
    """

    dataflows: Tuple[str, ...]
    formats: Tuple[Tuple[SparseFormat, SparseFormat], ...]
    block_multiple: int = 1

    def supports(self, dataflow: str, fmt_a: SparseFormat,
                 fmt_b: SparseFormat,
                 block_shape: Tuple[int, int, int]) -> bool:
        if dataflow not in self.dataflows:
            return False
        if (fmt_a, fmt_b) not in self.formats:
            return False
        return all(b % self.block_multiple == 0 for b in block_shape)


class ExecutionBackend(abc.ABC):
    """One execution substrate behind the plan API (see module docstring).

    Subclasses must be stateless with respect to individual plans: every
    per-pattern artifact belongs in the aux dict returned by :meth:`prepare`
    and stored *on the plan*, so one backend instance serves any number of
    plans.
    """

    name: str = "abstract"

    #: Can :class:`repro_torch.memory.TiledPlan` stream OP k-slabs as one
    #: lane of padded, shape-uniform slab sub-plans summed into one carry?
    #: Requires ``execute`` to take sub-plans whose work lists carry pad
    #: entries aimed one past the output grid (and drop them).  Both
    #: ``reference`` and ``cuda`` qualify; a backend that needs each tile's
    #: own unpadded plan leaves this ``False`` and gets the tile loop.
    scan_streaming: bool = False

    #: The ``plan.aux`` key under which this backend stores the
    #: :class:`repro_torch.kernels.StreamSchedule` its ``execute``
    #: consumes, or ``None`` for backends that execute straight off the
    #: index plan.  This is the registration seam for the static schedule
    #: checker (:mod:`repro_torch.analysis.schedule`): when set,
    #: ``verify_plan`` requires the key on every prepared plan and proves
    #: the schedule's invariant families over it, and over the uploaded
    #: ``device_schedule`` beside it.
    schedule_aux_key: Optional[str] = None

    @abc.abstractmethod
    def capabilities(self) -> BackendCapability:
        """Declare what this backend can run."""

    def supports(self, dataflow: str, fmt_a: SparseFormat,
                 fmt_b: SparseFormat,
                 block_shape: Tuple[int, int, int]) -> bool:
        return self.capabilities().supports(dataflow, fmt_a, fmt_b,
                                            block_shape)

    def prepare(self, plan) -> Dict[str, Any]:
        """Phase-1 auxiliary schedules for ``plan`` (pattern-only).

        Runs exactly once per plan, at plan time, and may upload what
        execution reads to ``plan.device``.  The returned dict rides on the
        plan (``plan.aux``) and is handed back to :meth:`execute`; it must
        depend only on the plan's sparsity *patterns*, never on values.
        """
        del plan
        return {}

    def uniform_aux(self, plans) -> None:
        """Make sibling plans' aux schedules shape-uniform so they stack.

        A backend whose aux arrays are work-list sized overrides this to pad
        them to shared extents *in place*; the default is a no-op.
        """
        del plans

    def tuning_knobs(self) -> Dict[str, Tuple[Any, ...]]:
        """Declare this backend's tunable execution knobs.

        Maps attribute name -> candidate values.  ``AutotunePolicy`` sweeps
        the cross product jointly with the dataflow choice and applies the
        winning values to the backend instance.  Default: no knobs.
        """
        return {}

    def reads_b_in_place(self, plan, b) -> bool:
        """Does :meth:`execute` take this dense ``b`` as it is, with no
        gather into the planned format?  Default: no backend does."""
        del plan, b
        return False

    @abc.abstractmethod
    def execute(self, plan, a, b, out_dtype) -> torch.Tensor:
        """Phase 2: run ``C = A @ B`` for compressed operands ``a``/``b``
        (BlockCSR/BlockCSC in the plan's Table 3 formats); ``b`` is the
        dense tensor itself where :meth:`reads_b_in_place` said so.

        Must not rebuild any phase-1 artifact —
        ``repro_torch.api.PHASE1_COUNTERS`` stays untouched.
        """

    def cost(self, shape: LayerShape, dataflow: str,
             spec: Optional[DeviceSpec] = None) -> float:
        """Estimated execution time in seconds for ``dataflow`` on ``shape``.

        The oracle that selection policies consult.  Default: the analytical
        roofline estimate on ``spec``; backends with better knowledge (cycle
        models, measurements) override.
        """
        return estimate(shape, dataflow, spec or DeviceSpec()).time_s


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ExecutionBackend] = {}


def register_backend(backend: ExecutionBackend, *,
                     overwrite: bool = False) -> ExecutionBackend:
    """Register ``backend`` under ``backend.name``."""
    if not overwrite and backend.name in _REGISTRY \
            and _REGISTRY[backend.name] is not backend:
        raise ValueError(f"backend {backend.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(backend: Union[str, ExecutionBackend]) -> ExecutionBackend:
    """Resolve a backend name (or pass an instance through, registering it).

    An instance whose name is already taken by a *different* instance is
    rejected — silently replacing the registered backend would re-target
    every existing plan that resolves that name.
    """
    if isinstance(backend, ExecutionBackend):
        existing = _REGISTRY.get(backend.name)
        if existing is None:
            register_backend(backend)
        elif existing is not backend:
            raise ValueError(
                f"a different backend is already registered as "
                f"{backend.name!r}; give your instance a unique .name or "
                "call register_backend(..., overwrite=True) explicitly")
        return backend
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(
            f"unknown backend {backend!r}; available: "
            f"{sorted(_REGISTRY)}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def allowed_dataflows(backend: ExecutionBackend,
                      block_shape: Tuple[int, int, int]) -> Tuple[str, ...]:
    """Capability negotiation: the dataflows ``backend`` admits at this block
    shape, with each dataflow's Table 3 operand formats."""
    return tuple(d for d in DATAFLOWS
                 if backend.supports(d, *TABLE3_FORMATS[d],
                                     tuple(block_shape)))
