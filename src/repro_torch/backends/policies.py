"""Dataflow ``SelectionPolicy`` — the swappable half of phase 1.

The paper's mapper/compiler estimates every dataflow's cost and picks one.
This module is that seam:

- :class:`HeuristicPolicy` — the analytical roofline estimate
  (:func:`repro_torch.core.selector.select_dataflow`), the default;
- :class:`FixedPolicy`     — always the given dataflow (what an explicit
  ``dataflow="ip_m"`` argument resolves to).

The JAX package's ``simulator``, ``autotune`` and ``learned`` policies are
not ported yet (ROADMAP queue 1, items 4 and 11); naming them raises
``NotImplementedError``.

A policy sees one :class:`SelectionContext` (shape features, occupancy
bitmaps, fingerprint, the target backend) and returns a dataflow name from
``ctx.allowed`` — the dataflows the backend's capability declaration admits.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Tuple, Union

import numpy as np

from ..core import dataflows as df
from ..core.selector import DeviceSpec, LayerShape, select_dataflow
from .base import ExecutionBackend, allowed_dataflows, get_backend

__all__ = [
    "SelectionContext",
    "SelectionPolicy",
    "HeuristicPolicy",
    "FixedPolicy",
    "get_policy",
]

_UNPORTED = {"simulator": 4, "autotune": 4, "learned": 11}


@dataclasses.dataclass
class SelectionContext:
    """Everything phase 1 knows when it asks a policy to choose.

    ``occ_a``/``occ_b`` are block-occupancy bitmaps (the pattern itself);
    ``allowed`` is pre-negotiated against the backend's capability
    declaration.
    """

    shape: LayerShape
    block_shape: Tuple[int, int, int]
    occ_a: np.ndarray
    occ_b: np.ndarray
    fingerprint: str
    backend: ExecutionBackend
    spec: DeviceSpec
    allowed: Tuple[str, ...]


class SelectionPolicy(abc.ABC):
    """One dataflow-selection strategy (see module docstring)."""

    name: str = "abstract"

    #: key under which a :class:`repro_torch.api.PlanCache` files plans
    #: built with this policy; stateful policies override.
    @property
    def cache_key(self) -> str:
        return self.name

    @abc.abstractmethod
    def select(self, ctx: SelectionContext) -> str:
        """Pick one dataflow from ``ctx.allowed``."""

    def select_for_shape(self, shape: LayerShape, *,
                         backend: Union[str, ExecutionBackend] = "reference",
                         spec: DeviceSpec = DeviceSpec(),
                         dtype="float32") -> str:
        """Select for shape features alone (dense-pattern context).

        For callers that have no concrete pattern, e.g. MoE dispatch
        planning, where the routing pattern only exists at run time.  The
        fingerprint carries the block shape and value dtype, as in the JAX
        package.
        """
        be = get_backend(backend)
        bm, bk, bn = shape.block
        occ_a = np.ones((-(-shape.m // bm), -(-shape.k // bk)), dtype=bool)
        occ_b = np.ones((-(-shape.k // bk), -(-shape.n // bn)), dtype=bool)
        ctx = SelectionContext(
            shape=shape, block_shape=tuple(shape.block), occ_a=occ_a,
            occ_b=occ_b,
            fingerprint=f"shape:{shape.m}x{shape.k}x{shape.n}"
                        f":{shape.density_a:.4f}:{shape.density_b:.4f}"
                        f":b{bm}x{bk}x{bn}:{np.dtype(dtype).name}",
            backend=be, spec=spec,
            allowed=allowed_dataflows(be, tuple(shape.block)))
        return self.select(ctx)


class HeuristicPolicy(SelectionPolicy):
    """The analytical roofline estimate (paper §5.2 traffic formulas)."""

    name = "heuristic"

    def select(self, ctx: SelectionContext) -> str:
        return select_dataflow(ctx.shape, ctx.spec, allowed=ctx.allowed)


class FixedPolicy(SelectionPolicy):
    """Always the given dataflow (an explicit ``dataflow=`` pin)."""

    name = "fixed"

    def __init__(self, dataflow: str):
        if dataflow not in df.DATAFLOWS:
            raise ValueError(f"unknown dataflow {dataflow!r}; "
                             f"expected one of {df.DATAFLOWS}")
        self.dataflow = dataflow

    @property
    def cache_key(self) -> str:
        return f"fixed:{self.dataflow}"

    def select(self, ctx: SelectionContext) -> str:
        if self.dataflow not in ctx.allowed:
            raise ValueError(
                f"backend {ctx.backend.name!r} does not support "
                f"{self.dataflow!r} at block_shape={ctx.block_shape}")
        return self.dataflow


_NAMED: Dict[str, SelectionPolicy] = {}


def get_policy(policy: Union[str, SelectionPolicy, None],
               dataflow: str = "auto") -> SelectionPolicy:
    """Resolve ``policy=`` / ``dataflow=`` arguments to one policy instance.

    - an explicit non-"auto" ``dataflow`` pins a :class:`FixedPolicy`
      (and wins over ``policy``);
    - ``policy`` may be ``"heuristic"``, a dataflow name (shorthand for a
      fixed pin) or an instance;
    - neither given → :class:`HeuristicPolicy`.
    """
    if dataflow != "auto":
        return FixedPolicy(dataflow)
    if policy is None:
        policy = "heuristic"
    if isinstance(policy, SelectionPolicy):
        return policy
    if policy in df.DATAFLOWS:
        return FixedPolicy(policy)
    if policy in _UNPORTED:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet (ROADMAP queue 1, item "
            f"{_UNPORTED[policy]}); use 'heuristic' or pin a dataflow")
    if policy != "heuristic":
        raise KeyError(f"unknown policy {policy!r}; expected 'heuristic', "
                       "a dataflow name, or a SelectionPolicy instance")
    inst = _NAMED.get(policy)
    if inst is None:
        inst = _NAMED[policy] = HeuristicPolicy()
    return inst
