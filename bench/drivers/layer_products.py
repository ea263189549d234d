"""Driver for a configuration that is a table of products: every layer of
the table applied through the plan API once a step.

Set-up draws each layer's block patterns from the seed (numpy) and its
values on the device (one ``torch.Generator`` draw for all of them), plans
each layer once with ``flexagon_plan`` on the ``cuda`` backend, packs A
(the weights) once, and warms up.  A step applies every layer, in table
order, to B (the activations) handed over dense; step ``i`` uses value
set ``i % value_sets``.  Steps run as one client with ``in_flight`` steps
outstanding: the host enqueues a step, then waits on the oldest.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List

import numpy as np
import torch

from bench import reference, tracing, work


@dataclasses.dataclass
class Layer:
    name: str
    shape: tuple            # (m, k, n), n for the whole step's samples
    occ_a: np.ndarray
    occ_b: np.ndarray
    a: torch.Tensor         # dense values, as the benchmark made them
    b_sets: List[torch.Tensor]
    flops: float
    nbytes: float
    plan: Any = None
    a_packed: Any = None


class _Stamp:
    """A point in the device's stream: a CUDA event on the card, the host
    clock elsewhere (where every operation has ended when it returns)."""

    def __init__(self, device):
        self.event = (torch.cuda.Event(enable_timing=True)
                      if device.type == "cuda" else None)
        self.t = None

    def record(self):
        if self.event is not None:
            self.event.record()
        else:
            self.t = time.perf_counter()
        return self

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def ms_until(self, other):
        if self.event is not None:
            return self.event.elapsed_time(other.event)
        return (other.t - self.t) * 1e3


def _seed(seed):
    return int(seed) % 2 ** 63


def make_layers(cfg, traffic, seed, device):
    """Patterns from the seed, values on ``device`` from the seed."""
    rng = np.random.default_rng(_seed(seed))
    block, batch = cfg["block"], traffic["samples_per_step"]
    sets = traffic["value_sets"]
    drawn = []
    for name, m, n1, k, sp_a, sp_b in cfg["layers"]:
        shape = (m, k, n1 * batch)
        occ_a = work.block_pattern(rng, (m, k), block, max(0.0, 1 - sp_a / 100))
        occ_b = work.block_pattern(rng, (k, shape[2]), block,
                                   max(0.0, 1 - sp_b / 100))
        drawn.append((name, shape, occ_a, occ_b))
    total = sum(m * k + sets * k * n for _, (m, k, n), _, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))
    values = torch.randn(total, generator=gen, device=device)
    layers, at = [], 0

    def take(rows, cols, occ):
        nonlocal at
        x = values[at: at + rows * cols].view(rows, cols)
        at += rows * cols
        mask = torch.as_tensor(occ, device=device)
        mask = mask.repeat_interleave(block, 0).repeat_interleave(block, 1)
        return x.mul_(mask[:rows, :cols])

    for name, (m, k, n), occ_a, occ_b in drawn:
        a = take(m, k, occ_a)
        b_sets = [take(k, n, occ_b) for _ in range(sets)]
        flops, nbytes = work.product_work(occ_a, occ_b, (m, k, n), block)
        layers.append(Layer(name, (m, k, n), occ_a, occ_b, a, b_sets,
                            flops, nbytes))
    return layers


class Run:
    """One cell's program state and what its window measured."""

    def __init__(self, cfg, traffic, seed, device):
        from repro_torch import flexagon_plan, obs

        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.batch = traffic["samples_per_step"]
        self.sets = traffic["value_sets"]
        self.in_flight = traffic["in_flight"]
        check_rng = np.random.default_rng([_seed(seed), 1])
        #: early steps whose outputs are kept for the check, one for each
        #: value set (the window's last steps are kept too)
        first = int(check_rng.integers(0, traffic["check"]["sample_below"]))
        self.sampled_steps = set(range(first, first + self.sets))
        self.layers = make_layers(cfg, traffic, seed, self.device)
        block = (cfg["block"],) * 3
        hist = obs.get_registry().histogram("plan.build_s")
        built = hist.snapshot()["sum"]
        for layer in self.layers:
            layer.plan = flexagon_plan(layer.a, layer.b_sets[0],
                                       block_shape=block, backend="cuda",
                                       device=self.device)
            layer.a_packed = layer.plan.pack_a(layer.a)
        self.plan_s = hist.snapshot()["sum"] - built
        self.flops_per_step = sum(x.flops for x in self.layers)
        self.apply_s = 0.0
        self.applies = 0
        self.kept = {}
        # every shape and every value set, with steps kept as the window
        # keeps them, so the allocator already holds what the window needs
        self.steps(count=traffic["warm_steps"],
                   keep=set(range(1, 1 + self.sets)))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bound_s_per_step(self, peaks):
        return sum(work.bound_s(x.flops, x.nbytes, peaks)
                   for x in self.layers)

    def _enqueue(self, i):
        bset = i % self.sets
        outs = []
        for layer in self.layers:
            t = time.perf_counter()
            outs.append(layer.plan.apply(layer.a_packed, layer.b_sets[bset]))
            self.apply_s += time.perf_counter() - t
        self.applies += len(self.layers)
        return outs

    def steps(self, seconds=None, count=None, keep=()):
        """Run steps until ``seconds`` have passed (no new step starts
        after, once every value set has had one) or ``count`` steps have
        run; returns (steps, host seconds
        from the first enqueue to the last completion, each step's device
        ms, the outputs by step of the steps in ``keep`` and of the last
        ``value_sets`` steps, so that every value set is among them)."""
        pending, last = deque(), deque(maxlen=self.sets)
        step_ms, kept, i = [], {}, 0
        t0 = time.perf_counter()
        while (count is None or i < count) and (
                seconds is None or i < self.sets
                or time.perf_counter() - t0 < seconds):
            start = _Stamp(self.device).record()
            outs = self._enqueue(i)
            end = _Stamp(self.device).record()
            pending.append((i, outs, start, end))
            if len(pending) >= self.in_flight:
                self._retire(pending.popleft(), step_ms, kept, keep, last)
            i += 1
        while pending:
            self._retire(pending.popleft(), step_ms, kept, keep, last)
        kept.update(last)
        return i, time.perf_counter() - t0, step_ms, kept

    def _retire(self, item, step_ms, kept, keep, last):
        """Wait for a step; keep its outputs if it is in ``keep``, and
        among the ``last`` ones."""
        j, outs, start, end = item
        end.wait()
        step_ms.append(start.ms_until(end))
        if j in keep:
            kept[j] = outs
        last.append((j, outs))

    def launches(self):
        from repro_torch.kernels import stream as ks

        return ks.stream_spmm.launches + ks.stream_panel_spmm.launches

    def window(self, seconds):
        """The measured window: a dict of what it counted."""
        self.apply_s, self.applies = 0.0, 0
        launches = self.launches()
        steps, window_s, step_ms, self.kept = self.steps(
            seconds=seconds, keep=self.sampled_steps)
        return {"steps": steps, "window_s": window_s, "step_ms": step_ms,
                "samples": steps * self.batch,
                "apply_s": self.apply_s, "applies": self.applies,
                "launches": self.launches() - launches}

    def trace(self):
        """Device ops, busy time and window over ``trace_steps`` steps
        traced on the device alone after 4 more; None off the card, and
        None where the trace holds fewer K1/K2 kernels than were launched
        or its operations do not divide into the steps (a trace that lost
        operations is no reading)."""
        if self.device.type != "cuda":
            return None
        count, warm = self.traffic["trace_steps"], 4
        before = self.launches()
        device = tracing.profile_steps(
            lambda: self.steps(count=warm + count))
        launched = self.launches() - before
        self._sync()
        names = ("stream_dest_kernel", "stream_panel_kernel")
        seen = sum(1 for n, _, _ in device if n in names)
        if seen != launched:
            return None
        return tracing.reduce(device, count, skip=warm)

    def free_program(self):
        """Drop the program's state (plans, packed weights)."""
        for layer in self.layers:
            layer.plan = layer.a_packed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _judge(self, outs_of, product):
        """max|out - ref| / max|ref| of ``product(outs, layer index, layer,
        value set)`` for each step ``j`` of ``outs_of`` (value set ``j %
        value_sets``), the references made layer by layer; returns (the
        worst, where it is, the worst of each step)."""
        per_step = {j: 0.0 for j in outs_of}
        worst, where = 0.0, None
        for li, layer in enumerate(self.layers):
            for bset in sorted({j % self.sets for j in outs_of}):
                ref = reference.product(layer.a, layer.b_sets[bset])
                for j, outs in outs_of.items():
                    if j % self.sets != bset:
                        continue
                    try:
                        err = reference.rel_err(product(outs, li, layer,
                                                        bset), ref)
                    except (RuntimeError, ValueError, IndexError):
                        err = float("inf")
                    if not err == err:          # NaN
                        err = float("inf")
                    per_step[j] = max(per_step[j], err)
                    if err >= worst:
                        worst, where = err, f"{layer.name} step {j}"
                del ref
        return worst, where, per_step

    def check(self):
        """The kept steps' outputs against the fp64 reference."""
        return self._judge(self.kept, lambda outs, li, layer, bset: outs[li])

    def control(self):
        """The control in the program's place: the reference in TF32 on
        the same operands, for the value sets the kept steps used."""
        return self._judge(
            {j % self.sets: None for j in self.kept},
            lambda outs, li, layer, bset: reference.control(
                layer.a, layer.b_sets[bset]))
