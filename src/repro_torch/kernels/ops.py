"""Public one-shot entry points over the plan API.

The port of ``repro.kernels.ops``.  Both functions run phase 1
(:func:`repro_torch.api.flexagon_plan`) and phase 2 (``plan.apply``) back to
back on every call, routed through the backend registry
(:mod:`repro_torch.backends`); no kernel is dispatched from this module.
N-stationary variants run through the backend's transpose duality
``C = (Bᵀ Aᵀ)ᵀ``.  The reference's ``use_pallas``/``interpret`` switches
have no counterpart: ``backend=`` names the substrate (``"cuda"`` for the
kernels), and ``device=None`` is the card.

.. deprecated::
    For anything called more than once per sparsity pattern — serving loops,
    per-layer inference, benchmarks — use the plan-once API instead::

        plan = flexagon_plan(a, b, block_shape=..., backend=...)
        c = plan.apply(a, b)          # reusable

    The shims re-inspect occupancy, re-run the selection policy and rebuild
    index plans per call, exactly the host-side cost the plan API amortizes.
    ``flexagon_spmm`` emits a :class:`DeprecationWarning`.
"""
from __future__ import annotations

import warnings
from typing import Literal

import torch

from ..core.selector import DeviceSpec

__all__ = ["flexagon_spmm", "spmm_with_dataflow"]

Dataflow = Literal["ip_m", "op_m", "gust_m", "ip_n", "op_n", "gust_n", "auto"]


def spmm_with_dataflow(a_dense, b_dense, dataflow: str,
                       block_shape=(128, 128, 128), *, backend=None,
                       device=None, out_dtype=torch.float32) -> torch.Tensor:
    """Run one specific dataflow on dense inputs (compression included).

    One-shot convenience over ``flexagon_plan(..., dataflow=...)``: phase 1
    per call."""
    from ..api import flexagon_plan

    plan = flexagon_plan(a_dense, b_dense, dataflow=dataflow,
                         block_shape=tuple(block_shape), backend=backend,
                         device=device)
    return plan.apply(a_dense, b_dense, out_dtype=out_dtype)


def flexagon_spmm(a_dense, b_dense, *, dataflow: Dataflow = "auto",
                  block_shape=(128, 128, 128), spec: DeviceSpec = DeviceSpec(),
                  backend=None, policy=None, device=None,
                  out_dtype=torch.float32):
    """SpMSpM with per-operation dataflow selection (the paper's headline).

    Returns ``(C, chosen_dataflow)``.

    .. deprecated::
        One-shot shim over the plan-once API — see the module docstring;
        prefer :func:`repro_torch.api.flexagon_plan` whenever a pattern
        repeats.
    """
    warnings.warn(
        "flexagon_spmm re-plans on every call; use "
        "repro_torch.api.flexagon_plan(...) once and plan.apply(...) per "
        "execution instead",
        DeprecationWarning, stacklevel=2)
    from ..api import flexagon_plan

    plan = flexagon_plan(a_dense, b_dense, dataflow=dataflow,
                         block_shape=tuple(block_shape), spec=spec,
                         backend=backend, policy=policy, device=device)
    return plan.apply(a_dense, b_dense, out_dtype=out_dtype), plan.dataflow
