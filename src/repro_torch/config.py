"""Process-wide execution knobs.

``REPRO_VERIFY`` — pre-execution plan verification default (see
``repro_torch.analysis.verify_plan``).  Unset or falsy, plans are handed
out unchecked; ``REPRO_VERIFY=1`` verifies every ``flexagon_plan`` /
``PlanCache`` build.  An explicit ``verify=`` argument at any call site
still wins.

:func:`resolve_device` — where an entry point runs.  ``device=None``
means the card (``cuda``); without one it raises rather than falling back
to the CPU.  Nothing else selects between a kernel and its plain version:
a kernel wrapper runs its plain version only for a tensor on the CPU.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["verify_default", "resolve_verify", "resolve_device"]

_TRUE = {"1", "true", "yes", "on"}


def verify_default() -> bool:
    """Global plan-verification default (``REPRO_VERIFY``), read per call."""
    return os.environ.get("REPRO_VERIFY", "").strip().lower() in _TRUE


def resolve_verify(explicit: Optional[bool] = None) -> bool:
    """An explicit per-call value wins; ``None`` defers to the global knob."""
    return verify_default() if explicit is None else bool(explicit)


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` resolves to ``cuda``; raise if no card is present then.

    An explicit device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    returned as a ``torch.device`` unchanged.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device=None resolves to 'cuda', but torch sees no CUDA device; "
            "pass device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda")
