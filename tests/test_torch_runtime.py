"""The port's fault-tolerance hooks: ``tests/test_runtime.py``'s cases over
the port's ``Checkpointer``."""
import numpy as np
import pytest

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerPolicy,
                                                 WorkerFailure,
                                                 elastic_mesh_shape,
                                                 run_with_recovery)


def test_heartbeat_detection():
    t = [0.0]
    hb = HeartbeatMonitor(4, timeout_s=10.0, clock=lambda: t[0])
    t[0] = 5.0
    hb.beat(0), hb.beat(1), hb.beat(2)
    t[0] = 12.0
    assert hb.check() == [3]
    assert sorted(hb.alive) == [0, 1, 2]
    t[0] = 30.0
    assert sorted(hb.check()) == [0, 1, 2]


def test_elastic_mesh_shapes():
    assert elastic_mesh_shape(256, 16) == (16, 16)
    assert elastic_mesh_shape(240, 16) == (15, 16)
    assert elastic_mesh_shape(512, 16, pods=2) == (2, 16, 16)
    assert elastic_mesh_shape(17, 16) == (1, 16)
    with pytest.raises(ValueError):
        elastic_mesh_shape(8, 16)


def test_straggler_escalation():
    sp = StragglerPolicy(factor=2.0, max_strikes=2)
    for _ in range(6):
        assert sp.observe(1.0) == "ok"
    assert sp.observe(10.0, worker=5) == "slow"
    assert sp.observe(10.0, worker=5) == "evict"
    assert sp.skipped == 2


def test_run_with_recovery(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"x": np.zeros(1)}, blocking=True)
    crashes = {"left": 2}

    def segment(start, mesh):
        for s in range(start, 20):
            if s == 10 and crashes["left"] > 0:
                crashes["left"] -= 1
                raise WorkerFailure(s % 4)
            if (s + 1) % 5 == 0:
                ck.save(s + 1, {"x": np.zeros(1)}, blocking=True)
        return 20

    report = run_with_recovery(segment, ck, total_steps=20,
                               initial_mesh=(16, 16), model_parallel=16)
    assert report["failures"] == 2
    assert report["final_step"] == 20
    assert report["mesh_history"] == [(16, 16), (15, 16), (14, 16)]


def test_recovery_gives_up_after_max_failures(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"x": np.zeros(1)}, blocking=True)

    def always_fail(start, mesh):
        raise WorkerFailure(0)

    with pytest.raises(WorkerFailure):
        run_with_recovery(always_fail, ck, total_steps=10,
                          initial_mesh=(16, 16), model_parallel=16,
                          max_failures=3)
