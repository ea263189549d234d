"""Shared helpers for the benchmark suite.

Every benchmark module exposes ``run() -> list[Row]``;
``repro_torch.benchmarks.run`` aggregates them into the ``name,us_per_call,derived`` CSV contract.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List

from .. import obs
from ..core.simulator import from_layer, simulate, ACCELERATORS
from ..core.workloads import TABLE2, model_layers

ACCEL_ORDER = ["sigma_like", "sparch_like", "gamma_like", "flexagon"]


@dataclasses.dataclass
class Row:
    name: str
    us_per_call: float
    derived: str
    extra: dict | None = None       # structured fields for --json consumers

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.2f},{self.derived}"

    def json(self) -> dict:
        payload = {"name": self.name, "us_per_call": self.us_per_call,
                   "derived": self.derived}
        if self.extra:
            payload.update(self.extra)
        return payload


def timed(fn: Callable, *args, **kwargs):
    t0 = obs.now_ns()
    out = fn(*args, **kwargs)
    return out, (obs.now_ns() - t0) / 1e3


@functools.lru_cache(maxsize=None)
def model_results(model: str) -> Dict[str, List]:
    """Simulate every layer of one model on all four accelerators (cached)."""
    layers = model_layers(model)
    out: Dict[str, List] = {a: [] for a in ACCELERATORS}
    for spec in layers:
        st = from_layer(spec)
        for a in ACCELERATORS:
            out[a].append(simulate(a, st))
    return out


def all_models():
    return [m.name for m in TABLE2]
