"""CPU tests of the training cell, ``granite-moe.train``: the driver
``lm_train`` through the harness at a toy size, faults planted in the
program that its check must fail, the trace join's training rule on a
synthetic trace, the readers given nothing, the work count, and what the
reference and the work count import; and, on a card, the control failing
the cell's limits through the harness's own comparison."""
import ast
import inspect
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import harness, train_trace, train_work
from bench.test_bench_harness import SPEC

HERE = Path(__file__).resolve().parent
CELL = "granite-moe.train"
#: the cell's new per-layer metrics
METRICS = ("k3_ms_per_step", "k3w_ms_per_step", "moe_roofline",
           "moe_dispatch_ms_per_step", "attn_ms_per_step",
           "optimizer_ms_per_step", "train_mfu", "train_host_idle_share")


def toy_config():
    """granite-moe.json's schema and scalars at a toy size: 2 layers,
    width 64, 4 experts of 32, 2 a token, vocab 256."""
    cfg = json.loads((HERE / "configs" / "granite-moe.json").read_text())
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=32,
               num_local_experts=4, num_experts_per_tok=2, vocab_size=256)
    return cfg


def toy_traffic():
    traffic = json.loads((HERE / "traffic" / "train_s4096.json")
                         .read_text())
    traffic.update(sequences_per_step=2, seq_len=32, warm_steps=1,
                   min_steps=4, trace_steps=1, check={"sample_below": 2})
    return traffic


def run_toy(seed=2 ** 31 + 11, trace=0):
    return harness.run(SPEC, CELL, seed, 0.05, trace, "cpu",
                       time.perf_counter(), cfg=toy_config(),
                       traffic=toy_traffic())


@pytest.mark.parametrize("trace", [0, 1])
def test_the_toy_cell_is_correct_on_cpu(trace):
    result, lines = run_toy(trace=trace)
    assert result["correct"] and result["failed"] == 0, lines
    assert result["attempted"] >= 4
    assert set(result["metrics"]) == (
        {"setup_s", "samples_per_s", "step_ms_p95"} if not trace else set())
    limits = toy_config()["limits"]
    assert set(result["checks"]) == set(limits)
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"] == limits[name]
    # two steps kept: one of the first two, and the last
    kept = json.loads(lines[1][len("checked steps "):].split("]")[0] + "]")
    assert len(kept) == 2 and kept[0] < 2
    assert kept[1] == result["attempted"] - 1


def test_the_cell_states_the_registrys_model():
    """The configuration file's published values are the registry's, so
    the driver runs the registry's granite, its dispatch aside."""
    import dataclasses

    from repro_torch.configs import get_config

    from bench.drivers.lm_train import program_config

    cell = harness.cell_of(SPEC, CELL)
    cfg = harness.config_of(SPEC, cell)
    traffic = harness.traffic_of(cell["traffic"])
    base = get_config(cfg["arch"])
    assert program_config(cfg, traffic) == dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, strategy="sort"))
    assert (traffic["sequences_per_step"], traffic["seq_len"],
            traffic["microbatches"], traffic["remat"]) == (4, 4096, 1, True)
    assert traffic["min_steps"] >= 20 and cell["chips"] == 1
    assert set(cfg["limits"]) == {"loss_rel_err", "grad_rel_err",
                                  "route_gap", "update_rel_err"}


def test_the_cells_optimizer_is_the_programs():
    """The configuration's ``optimizer`` states the program's defaults, so
    the reference's AdamW step is the one the program should take."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import optimizer

    hp = harness.config_of(SPEC, harness.cell_of(SPEC, CELL))["optimizer"]
    t = TrainConfig()
    assert (hp["lr"], hp["warmup_steps"], hp["total_steps"],
            hp["weight_decay"], hp["grad_clip"]) == (
        t.lr, t.warmup_steps, t.total_steps, t.weight_decay, t.grad_clip)
    kw = inspect.signature(optimizer.adamw_update).parameters
    assert (hp["b1"], hp["b2"], hp["eps"]) == tuple(
        kw[n].default for n in ("b1", "b2", "eps"))
    assert inspect.signature(optimizer.cosine_schedule).parameters[
        "final_frac"].default == hp["final_lr_frac"]


# -- faults planted in the program ---------------------------------------------


def router_gradient_zeroed(monkeypatch):
    from repro_torch.models import moe

    def router(p, x, top_k):
        return moe._route(torch.matmul(
            x.float(), p["router"]["w"].float().detach()), top_k)

    monkeypatch.setattr(moe, "_router", router)


def one_expert_fewer(monkeypatch):
    from repro_torch.models import moe

    route = moe._route
    monkeypatch.setattr(moe, "_route",
                        lambda logits, top_k: route(logits, top_k - 1))


def residual_scale_left_out(monkeypatch):
    from repro_torch.models import decoder

    monkeypatch.setattr(decoder, "_branch", lambda cfg, h: h)


def optimizer_left_out(monkeypatch):
    """AdamW a no-op: the parameters stay as they were (the step count
    still moves)."""
    from repro_torch.train import trainer

    def same(params, grads, state, **kw):
        return params, state._replace(step=state.step + 1)

    monkeypatch.setattr(trainer, "adamw_update", same)


def update_sign_flipped(monkeypatch):
    """The update applied against its direction."""
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.train import trainer

    update = trainer.adamw_update

    def flipped(params, grads, state, **kw):
        new, opt = update(params, grads, state, **kw)
        return tree_map(lambda p, q: 2 * p - q, params, new), opt

    monkeypatch.setattr(trainer, "adamw_update", flipped)


def last_expert_one_down(monkeypatch):
    """Every token's last expert the next one down the ranking (its
    (k+1)-th in place of its k-th): a fault that only moves near ties
    where the two nearly tie, and moves every token."""
    from repro_torch.models import moe

    route = moe._route

    def route_down(logits, top_k):
        gates, experts, probs = route(logits, top_k + 1)
        keep = torch.cat([experts[:, :top_k - 1], experts[:, top_k:]], 1)
        g = probs.gather(1, keep)
        return g / g.sum(-1, keepdim=True), keep, probs

    monkeypatch.setattr(moe, "_route", route_down)


def grad_leaf_off(factor):
    """The first gradient leaf times ``factor``: a leaf doubled reads 1.0.
    A leaf off by 1% is not caught: the limit lies above the program's
    own bf16 error (``PERF.md`` §2)."""
    def plant(monkeypatch):
        from repro_torch.checkpoint.checkpointer import (tree_flatten,
                                                         tree_unflatten)
        from repro_torch.train import trainer

        value_and_grad = trainer._value_and_grad

        def off(*args, **kw):
            loss, grads = value_and_grad(*args, **kw)
            leaves = tree_flatten(grads)
            leaves[0] = leaves[0] * factor
            return loss, tree_unflatten(grads, leaves)

        monkeypatch.setattr(trainer, "_value_and_grad", off)

    plant.__name__ = f"grad_leaf_off_{factor}"
    return plant


@pytest.mark.parametrize("fault, fails", [
    (router_gradient_zeroed, "grad_rel_err"),
    (one_expert_fewer, "route_gap"),
    (residual_scale_left_out, "loss_rel_err"),
    (grad_leaf_off(2.0), "grad_rel_err"),
    (optimizer_left_out, "update_rel_err"),
    (update_sign_flipped, "update_rel_err"),
    (last_expert_one_down, "route_gap")], ids=lambda f: getattr(
        f, "__name__", f))
def test_a_planted_fault_fails_the_check(monkeypatch, fault, fails):
    fault(monkeypatch)
    result, lines = run_toy()
    assert not result["correct"] and result["failed"] == 2, lines
    check = result["checks"][fails]
    assert check["value"] > check["limit"], lines


def test_a_loss_not_reproduced_fails_the_check(monkeypatch):
    """A replay that does not give the step's loss bit for bit (here every
    call's loss another) reads inf in both numbers."""
    from repro_torch.train import trainer

    value_and_grad, calls = trainer._value_and_grad, []

    def drifting(*args, **kw):
        loss, grads = value_and_grad(*args, **kw)
        calls.append(None)
        return loss * (1 + 1e-6 * len(calls)), grads

    monkeypatch.setattr(trainer, "_value_and_grad", drifting)
    result, lines = run_toy()
    assert not result["correct"] and result["failed"] == 2
    assert all(c["value"] == float("inf")
               for c in result["checks"].values())
    assert "is not the step's" in lines[1]


# -- the trace join's training rule ---------------------------------------------


def _synthetic():
    """A step on a synthetic trace: the stepping thread's spans (tid 100),
    autograd's (200), its backward nodes, the forward operators they
    name, and launch calls (thread ids in the trace's own encoding)."""
    spans = [(0, 100, "train.step", 100), (0, 40, "train.forward", 100),
             (5, 15, "block.attn", 100), (20, 30, "moe.experts", 100),
             (40, 90, "train.backward", 100),
             (90, 100, "train.optimizer", 100),
             (45, 50, "block.attn", 200),
             (60, 65, "moe.experts.backward", 200)]
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 6, "dur": 1,
         "tid": 7, "args": {"Sequence number": 11, "Fwd thread id": 0}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 22,
         "dur": 1, "tid": 7, "args": {"Sequence number": 12,
                                      "Fwd thread id": 0}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 46,
         "dur": 1, "tid": 9, "args": {"Sequence number": 11,
                                      "Fwd thread id": 0}},
    ]
    for start, end, seq in ((44, 52, 50), (58, 66, 13), (70, 75, 11),
                            (76, 80, 12), (81, 85, 99)):
        events.append({"ph": "X", "cat": "cpu_op",
                       "name": f"{train_trace.NODE}: Node{seq}", "ts": start,
                       "dur": end - start, "tid": 9,
                       "args": {"Sequence number": seq, "Fwd thread id": 1}})
    launch_at = {1: 7, 2: 46, 3: 72, 4: 77, 5: 82, 6: 61, 7: 95, 8: 88,
                 9: 200}
    launches = {c: (t, t + 0.5, 555) for c, t in launch_at.items()}
    return spans, {"traceEvents": events}, launches


def test_the_training_rule_names_each_launch_owner():
    spans, trace, launches = _synthetic()
    windows = [(0, 40)]
    nodes = train_trace.backward_nodes(trace)
    assert len(nodes) == 5
    fwd = train_trace.forward_ops(trace, windows)
    assert fwd == {11: [6.0], 12: [22.0]}
    got = train_trace.owners(launches, spans, 100, nodes, fwd)
    assert got == {
        1: "block.attn",            # the forward, in its span
        2: "block.attn",            # the recomputation, on autograd's
        3: "block.attn",            # a backward node, by its forward op
        4: "moe.experts",
        5: "train.backward",        # a node whose forward is not seen
        6: "moe.experts.backward",  # autograd's own span wins
        7: "train.optimizer",
        8: "train.backward",        # the backward, outside any node
    }                               # 9: outside every span


def test_the_training_rule_and_the_unattributed_share():
    spans, trace, launches = _synthetic()
    nodes = train_trace.backward_nodes(trace)
    owner = train_trace.owners(launches, spans, 100, nodes,
                               train_trace.forward_ops(trace, [(0, 40)]))
    ops = [("gmm_mma_kernel", 62.0, 72.0, 6), ("elementwise", 8.0, 9.0, 1),
           ("elementwise", 73.0, 74.0, 3), ("adamw", 96.0, 99.0, 7)]
    p = train_trace.summarize(ops, launches, owner, steps=1)
    assert p["experts_outside"] == 0 and p["unattributed_s"] == 0.0
    assert p["span_ms"] == pytest.approx({
        "moe.experts.backward": 0.01, "block.attn": 0.002,
        "train.optimizer": 0.003})
    assert ["moe.experts.backward/gmm_mma_kernel", 1e-5] in p["device_ops"]
    assert train_trace.train_rule(p) is None
    # a K3 kernel launched from attention's span breaks the rule
    bad = ops + [("gmm_mma_kernel", 10.0, 11.0, 1)]
    p = train_trace.summarize(bad, launches, owner, steps=1)
    assert "1 K3/K3w kernels outside" in train_trace.train_rule(p)
    # a kernel no span launched, over 0.5% of the device time
    lost = ops + [("elementwise", 200.0, 201.0, 9)]
    p = train_trace.summarize(lost, launches, owner, steps=1)
    assert "unattributed" in harness_fault(p)


def harness_fault(p):
    from bench import tracing

    return tracing.join_fault(p, train_trace.train_rule)


def test_readers_given_none_return_none():
    from types import SimpleNamespace

    ctx = SimpleNamespace(trace=None, run=None, peaks=None, steps=0,
                          flops_per_step=None, window_s=0.0)
    for name in METRICS:
        assert harness.reader_of(name)(ctx) is None, name


def test_readers_read_the_trace():
    from types import SimpleNamespace

    from bench import work

    class FakeRun:
        trace_rows = None

        def moe_bound_s_per_step(self, peaks):
            return 0.01

    trace = {"steps": 2, "ops": {"gmm_mma_kernel": 0.03,
                                 "gmm_reduce_kernel": 0.01,
                                 "wgrad_tma_kernel": 0.02},
             "window_s": 3.0, "busy_s": 2.7, "device_s": 2.7}
    ctx = SimpleNamespace(trace=trace, run=FakeRun(),
                          peaks=work.peaks_for("H100"), steps=10,
                          flops_per_step=5e13, window_s=20.0,
                          train_trace={"span_ms": {"moe.route": 1.0,
                                                   "moe.permute": 2.0,
                                                   "moe.combine": 3.0,
                                                   "block.attn": 4.0,
                                                   "train.optimizer": 5.0}})
    read = {n: harness.reader_of(n) for n in METRICS}
    assert read["k3_ms_per_step"](ctx) == pytest.approx(20.0)
    assert read["k3w_ms_per_step"](ctx) == pytest.approx(10.0)
    assert read["moe_roofline"](ctx) == pytest.approx(100 * 0.02 / 0.06)
    assert read["moe_dispatch_ms_per_step"](ctx) == 6.0
    assert read["attn_ms_per_step"](ctx) == 4.0
    assert read["optimizer_ms_per_step"](ctx) == 5.0
    assert read["train_mfu"](ctx) == pytest.approx(
        100 * 5e14 / (20.0 * 989.4e12))
    assert read["train_host_idle_share"](ctx) is None


def test_spec_holds_the_cell_and_its_metrics():
    per = {m["name"]: m for m in SPEC["per_layer"]}
    for name in METRICS:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["moves"] == "samples_per_s"
    assert {m["name"] for m in harness.metrics_of(SPEC, CELL, 1)} \
        == set(METRICS)
    assert [c["name"] for c in SPEC["workloads"]][-1] == CELL
    assert [c["name"] for c in SPEC["configs"]][-1] == "granite-moe"


# -- the work count --------------------------------------------------------------


def test_work_of_the_published_model():
    cfg = json.loads((HERE / "configs" / "granite-moe.json").read_text())
    # per layer: q, o 1024 x 1024; k, v 1024 x 512; router 1024 x 32;
    # 8 experts x 3 x 1024 x 512; then the tied head 1024 x 49155
    per_layer = 2 * 1024 * 1024 + 2 * 1024 * 512 + 1024 * 32 \
        + 8 * 3 * 1024 * 512
    assert train_work.active_matmul_params(cfg) == 24 * per_layer \
        + 1024 * 49155
    flops = train_work.model_flops_per_step(cfg, 4, 4096)
    assert flops == 6 * train_work.active_matmul_params(cfg) * 16384 \
        + 6 * 4096 ** 2 * 1024 * 24 * 4
    k3, k3w = train_work.moe_calls_per_step(cfg, 4, 4096)
    assert (len(k3), len(k3w)) == (24 * 9, 24 * 3)
    rows = 16384 * 8
    assert k3[0] == (2.0 * rows * 1024 * 512,
                     2.0 * (rows * 1024 + 32 * 1024 * 512 + rows * 512))
    assert k3w[0][1] == 2.0 * (rows * 1024 + rows * 512) \
        + 4.0 * 32 * 1024 * 512
    peaks = {"bf16_flop_per_s": 1e15, "hbm_bytes_per_s": 1e12}
    assert train_work.moe_bound_s_per_step(cfg, 4, 4096, peaks) == \
        pytest.approx(sum(max(f / 1e15, b / 1e12) for f, b in k3 + k3w))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["granite_moe_ref.py", "train_work.py"])
def test_reference_and_work_import_only_stdlib_numpy_torch(name):
    assert set(_imports(HERE / name)) <= set(sys.stdlib_module_names) | {
        "__future__", "numpy", "torch"}


# -- on a card ------------------------------------------------------------------


#: the card test's cell: granite's published widths at 4 of its 24 layers,
#: 2 sequences of 1,024 tokens a step
CARD_LAYERS, CARD_SEQS, CARD_LEN = 4, 2, 1024
CARD_SEEDS = (2 ** 31 + 3, 2 ** 31 + 5)


@pytest.mark.card
def test_control_fails_and_program_passes_on_the_card(card):
    """The control (the reference in float8 e4m3 in the program's place)
    fails the cell's limits through the harness's own comparison, while
    the program passes them, on two seeds.  Run it there with
    ``PYTHONPATH=src python -m pytest -q bench/test_bench_lm_train.py``."""
    from bench.drivers.lm_train import Run

    cell = harness.cell_of(SPEC, CELL)
    cfg = dict(harness.config_of(SPEC, cell),
               num_hidden_layers=CARD_LAYERS)
    traffic = dict(harness.traffic_of(cell["traffic"]),
                   sequences_per_step=CARD_SEQS, seq_len=CARD_LEN,
                   min_steps=3, check={"sample_below": 2})
    limits = cfg["limits"]
    for seed in CARD_SEEDS:
        run = Run(cfg, traffic, seed, card)
        run.window(0.0)
        run.free_program()
        program, _, per = harness._checked(run.check(), limits)
        assert all(not harness._fails(v, limits[n])
                   for got in per.values() for n, v in got.items()), per
        control, where, _ = harness._checked(run.control(), limits)
        assert any(harness._fails(control[n], lim)
                   for n, lim in limits.items()), (control, where)
        del run
