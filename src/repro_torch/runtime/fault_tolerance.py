"""Fault tolerance: failure detection, checkpoint/restart, elastic re-mesh,
straggler mitigation.

The port of ``repro.runtime.fault_tolerance``, over the port's
:class:`~repro_torch.checkpoint.checkpointer.Checkpointer`; nothing here
touches a device.

On a real cluster these hooks bind to the coordinator (GCS / Borg / SLURM);
here the control plane is in-process and failures are *injected
deterministically* so every policy is unit-testable on CPU:

- :class:`HeartbeatMonitor` — workers report heartbeats; silence beyond
  ``timeout_s`` marks a worker dead.
- :func:`elastic_mesh_shape` — given surviving device count, the largest
  (data, model) grid that preserves the model axis (TP degree is fixed by
  memory; elasticity reduces the data axis).
- :class:`StragglerPolicy` — per-step deadline at ``factor ×`` the rolling
  median; slow steps are logged and, past ``max_strikes`` for one worker,
  escalate to eviction (treated as a failure → elastic restart).
- :func:`run_with_recovery` — the supervision loop: run, on failure restore
  the latest checkpoint onto the surviving mesh, resume the data stream at
  the restored step (the pipeline is counter-based, so resume is exact).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["WorkerFailure", "HeartbeatMonitor", "elastic_mesh_shape",
           "StragglerPolicy", "run_with_recovery"]


class WorkerFailure(RuntimeError):
    def __init__(self, worker: int, reason: str = "heartbeat timeout"):
        super().__init__(f"worker {worker} failed: {reason}")
        self.worker = worker


@dataclasses.dataclass
class HeartbeatMonitor:
    num_workers: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last: Dict[int, float] = {w: now for w in range(self.num_workers)}
        self._dead: set = set()

    def beat(self, worker: int, t: Optional[float] = None):
        if worker not in self._dead:
            self._last[worker] = self.clock() if t is None else t

    def mark_dead(self, worker: int):
        self._dead.add(worker)

    def check(self, t: Optional[float] = None) -> List[int]:
        """Returns newly-dead workers."""
        now = self.clock() if t is None else t
        newly = [w for w, last in self._last.items()
                 if w not in self._dead and now - last > self.timeout_s]
        self._dead.update(newly)
        return newly

    @property
    def alive(self) -> List[int]:
        return [w for w in range(self.num_workers) if w not in self._dead]


def elastic_mesh_shape(devices_alive: int, model_parallel: int,
                       pods: int = 1) -> Tuple[int, ...]:
    """Largest mesh preserving the TP degree.

    TP degree is pinned by per-device memory; elasticity shrinks the data
    axis to the largest value with pods × data × model ≤ devices_alive.
    """
    if devices_alive < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{devices_alive} devices")
    data = devices_alive // (model_parallel * pods)
    if data < 1:
        pods, data = 1, devices_alive // model_parallel
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 3.0
    window: int = 32
    max_strikes: int = 3

    def __post_init__(self):
        self._times: List[float] = []
        self._strikes: Dict[int, int] = {}
        self.skipped: int = 0

    def deadline(self) -> float:
        if len(self._times) < 4:
            return float("inf")
        return self.factor * float(np.median(self._times[-self.window:]))

    def observe(self, step_time: float, worker: int = 0) -> str:
        """Returns "ok", "slow" (logged) or "evict" (escalate)."""
        verdict = "ok"
        if step_time > self.deadline():
            self.skipped += 1
            self._strikes[worker] = self._strikes.get(worker, 0) + 1
            verdict = ("evict" if self._strikes[worker] >= self.max_strikes
                       else "slow")
        else:
            self._strikes[worker] = 0
        self._times.append(step_time)
        return verdict


def run_with_recovery(train_segment: Callable[[int, Tuple[int, ...]], int],
                      checkpointer, *, total_steps: int,
                      initial_mesh: Tuple[int, ...],
                      model_parallel: int,
                      max_failures: int = 8) -> Dict[str, object]:
    """Supervision loop.

    ``train_segment(start_step, mesh_shape) -> reached_step`` runs until it
    either finishes or raises :class:`WorkerFailure`.  On failure we shrink
    the mesh (simulating the lost node) and resume from the last checkpoint.
    Returns a report of failures handled and mesh history.
    """
    mesh = tuple(initial_mesh)
    devices = int(np.prod(mesh))
    failures = 0
    history = [mesh]
    step = checkpointer.latest_step() or 0
    while step < total_steps:
        try:
            step = train_segment(step, mesh)
        except WorkerFailure:
            failures += 1
            if failures > max_failures:
                raise
            devices -= model_parallel        # lose one TP group worth
            mesh = elastic_mesh_shape(devices, model_parallel)
            history.append(mesh)
            step = checkpointer.latest_step() or 0
    return {"failures": failures, "mesh_history": history,
            "final_step": step}
