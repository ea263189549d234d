"""The check fails a broken timed path: each fault the cells can have is
planted under the plan API's ``apply`` and a run on the CPU (the
harness's look for a card skipped) must come out not correct.

The faults: an answer altered where it is produced; half of the batch
(the last half of the samples' columns) left out; a step that returns
its state unchanged (every apply hands back its first output).  The
cells run on one card, so no exchange between cards can be left out.
"""
import pytest
import torch

from bench.test_bench_harness import run_tiny


def altered(out, plan, cache):
    out = out.clone()
    out.view(-1)[out.numel() // 2] += 0.01 * float(out.abs().max())
    return out


def half_batch(out, plan, cache):
    out = out.clone()
    out[:, out.shape[1] // 2:] = 0
    return out


def unchanged(out, plan, cache):
    return cache.setdefault(id(plan), out)


@pytest.mark.parametrize("fault", [altered, half_batch, unchanged])
def test_fault_fails_the_check(monkeypatch, fault):
    from repro_torch.api import FlexagonPlan

    apply, cache = FlexagonPlan.apply, {}

    def broken(self, a, b, out_dtype=torch.float32):
        return fault(apply(self, a, b, out_dtype), self, cache)

    monkeypatch.setattr(FlexagonPlan, "apply", broken)
    result, lines = run_tiny()
    assert not result["correct"] and result["failed"] > 0
    check = result["checks"]["max_rel_err"]
    assert check["value"] > check["limit"]
    assert lines[-1].startswith("max_rel_err ")
