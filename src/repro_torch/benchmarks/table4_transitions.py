"""Table 4 / contribution (2) — inter-layer dataflow planning.

For each Table-2 model, compare two phase-1 policies over its layer sequence:

- *greedy*: best dataflow per layer in isolation (what a fixed-assignment
  mapper would do), paying an explicit CSR↔CSC conversion whenever the
  produced format cannot feed the next layer (Table 4 "EC" cells);
- *planned*: `plan_network`'s dynamic program over Table-4 legality, which
  trades a slightly slower layer for avoided conversions.

``derived`` reports conversions under each policy and the net time saved —
the paper's claim is that format-aware sequencing removes explicit
conversions entirely in most networks.
"""
from __future__ import annotations

from ..core.selector import (LayerShape, estimate_all, plan_network,
                                 select_dataflow, transition_needs_conversion,
                                 DeviceSpec)
from ..core.workloads import model_layers
from .common import Row, all_models, timed

SPEC = DeviceSpec()


def _shapes(model: str):
    out = []
    for spec in model_layers(model):
        out.append(LayerShape(
            m=spec.m, k=spec.k, n=spec.n,
            density_a=spec.density_a, density_b=spec.density_b))
    return out


def _conv_cost(l: LayerShape) -> float:
    return 2.0 * l.m * l.k * SPEC.dtype_bytes * l.density_a / SPEC.hbm_bw


def run() -> list[Row]:
    rows = []
    for model in all_models():
        (shapes,), us = timed(lambda m: (_shapes(m),), model)
        greedy = [select_dataflow(s, SPEC) for s in shapes]
        planned = plan_network(shapes, SPEC)

        def total(seq):
            t = sum(estimate_all(s, SPEC)[d].time_s
                    for s, d in zip(shapes, seq))
            convs = 0
            for i, (a, b) in enumerate(zip(seq, seq[1:]), start=1):
                if transition_needs_conversion(a, b):
                    convs += 1
                    t += _conv_cost(shapes[i])
            return t, convs

        t_greedy, c_greedy = total(greedy)
        t_planned, c_planned = total(planned)
        rows.append(Row(
            f"table4/{model}", us,
            f"greedy_convs={c_greedy} planned_convs={c_planned} "
            f"time_saved={100 * (1 - t_planned / max(t_greedy, 1e-12)):.1f}%",
        ))
    return rows
