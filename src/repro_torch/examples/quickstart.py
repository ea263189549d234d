"""Quickstart: the paper in one script, on the port.

1. Build two sparse matrices, run C = A @ B through all six SpMSpM dataflows
   on both execution backends — ``reference`` (plain PyTorch) and ``cuda``
   (the hand-written kernels K1/K2 on the card; their plain versions on the
   CPU) — everyone agrees with the dense oracle.
2. Plan once with the phase-1 mapper/compiler (``flexagon_plan``), execute
   many, swap selection policies (heuristic, the cycle-level simulator,
   autotune, learned), and chain layers with ``FlexagonPipeline``.
3. Give the plan a ``memory_budget`` (the paper's 3-tier memory hierarchy):
   an over-budget pattern auto-tiles into a ``TiledPlan``, and the
   simulator reports per-tier (L1/L2/DRAM) traffic; ``dataflow="mixed"``
   picks each tile's dataflow.
4. Give the plan a ``mesh``: phase 1 partitions it into a ``ShardedPlan``
   (OP k-slabs merge partial sums, priced as an interconnect tier).
5. Reproduce the paper's headline on one Table 6 layer with the cycle-level
   simulator: Flexagon == best of {SIGMA-like, SpArch-like, GAMMA-like}.

The port of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from .. import (FlexagonPipeline, MemoryBudget, ShardedPlan, SparseOperand,
                TiledPlan, available_backends, flexagon_plan, get_backend,
                get_policy, obs)
from ..core import DATAFLOWS, LayerShape, random_sparse_dense, select_dataflow
from ..core.simulator import ACCELERATORS, from_layer, simulate
from ..core.workloads import PAPER_LAYERS
from ..kernels import stream
from ..launch.mesh import make_virtual_mesh

#: the worst error any apply may show against the fp64 oracle
TOL = 1e-4


def _err(out, ref) -> float:
    return float(np.abs(out.double().cpu().numpy() - ref).max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    a_np = random_sparse_dense(rng, (64, 64), density=0.3,
                               block_shape=(16, 16))
    b_np = random_sparse_dense(rng, (64, 96), density=0.6,
                               block_shape=(16, 16))
    oracle = a_np.astype(np.float64) @ b_np.astype(np.float64)
    a = torch.as_tensor(a_np, device=device)
    b = torch.as_tensor(b_np, device=device)
    worst = 0.0
    launches0 = stream.stream_spmm.launches + stream.stream_panel_spmm.launches

    print(f"== six dataflows × two backends, one answer "
          f"(registry: {', '.join(available_backends())}) ==")
    for df in DATAFLOWS:
        errs = []
        for backend in ("reference", "cuda"):
            plan = flexagon_plan(a, b, dataflow=df, block_shape=(16, 16, 16),
                                 backend=backend, device=device)
            e = _err(plan.apply(a, b), oracle)
            worst = max(worst, e)
            errs.append(f"{backend} {e:.2e}")
        print(f"  {df:8s} max|err| = {' | '.join(errs)}")
    kernel_launches = (stream.stream_spmm.launches
                       + stream.stream_panel_spmm.launches - launches0)
    print(f"  K1/K2 launches: {kernel_launches} "
          f"({'kernels' if device.type == 'cuda' else 'plain versions'} "
          f"on {device})")

    print("== plan once (phase 1), execute many (phase 2) ==")
    plan = flexagon_plan(a, b, block_shape=(16, 16, 16), device=device)
    print(f"  selector picked {plan.dataflow!r} "
          f"(est {plan.estimate.time_s * 1e9:.1f} ns on DeviceSpec), "
          f"output major order {plan.out_major!r}, "
          f"backend {plan.backend!r}")
    print("== swap the selection policy (same plan surface) ==")
    for pname in ("heuristic", "simulator"):
        p = flexagon_plan(a, b, block_shape=(16, 16, 16), policy=pname,
                          device=device)
        print(f"  policy {pname!r:12s} -> {p.dataflow}")
    autotuned = flexagon_plan(a, b, block_shape=(16, 16, 16),
                              policy=get_policy("autotune"), device=device)
    print(f"  policy 'autotune'  -> {autotuned.dataflow} "
          "(measured on the device, cached by pattern fingerprint)")
    learned_pol = get_policy("learned")
    learned = flexagon_plan(a, b, block_shape=(16, 16, 16),
                            policy=learned_pol, device=device)
    mode = "fitted model" if learned_pol.model is not None \
        else "model-less, heuristic fallback"
    print(f"  policy 'learned'   -> {learned.dataflow} ({mode})")
    e = _err(plan.apply(a, b), oracle)
    worst = max(worst, e)
    print(f"  plan.apply          max|err| = {e:.2e}")
    # same pattern, new values — no re-planning
    a2 = a * 3.0
    e = _err(plan.apply(a2, b), 3.0 * oracle)
    worst = max(worst, e)
    print(f"  plan.apply(3A, B)   max|err| = {e:.2e}")
    a_packed = plan.pack_a(a)
    assert isinstance(a_packed, SparseOperand)
    print(f"  packed A: {a_packed.fmt.value}, {a_packed.nnzb} blocks "
          f"(density {a_packed.density:.2f})")
    for name, spec in list(PAPER_LAYERS.items())[:3]:
        shape = LayerShape(spec.m, spec.k, spec.n,
                           spec.density_a, spec.density_b)
        print(f"  layer {name}: selector says {select_dataflow(shape)}")

    print("== plan_network pipeline (Table 4 transitions) ==")
    w1 = random_sparse_dense(rng, (96, 64), density=0.4, block_shape=(16, 16))
    w2 = random_sparse_dense(rng, (64, 32), density=0.6, block_shape=(16, 16))
    weights = [b, torch.as_tensor(w1, device=device),
               torch.as_tensor(w2, device=device)]
    pipe = FlexagonPipeline.from_weights(weights, tokens=64,
                                         block_shape=(16, 16, 16),
                                         device=device)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    y = pipe.apply(torch.as_tensor(x, device=device))
    ref = x.astype(np.float64) @ b_np @ w1 @ w2
    e = _err(y, ref) / max(1.0, float(np.abs(ref).max()))
    worst = max(worst, e)
    print(f"  dataflows {pipe.dataflows}, majors {pipe.majors}, "
          f"{pipe.n_conversions} explicit conversions")
    print(f"  chain max|err| / max|ref| = {e:.2e}")

    print("== out-of-core: memory_budget tiles what doesn't fit on chip ==")
    budget = MemoryBudget(l1_bytes=4 << 10, l2_bytes=8 << 10)
    tiled = flexagon_plan(a, b, block_shape=(16, 16, 16),
                          memory_budget=budget, device=device)
    assert isinstance(tiled, TiledPlan)
    e = _err(tiled.apply(a, b), oracle)
    worst = max(worst, e)
    print(f"  {tiled.dataflow!r} in {tiled.n_tiles} tiles "
          f"(merge regions: {tiled.merge_plan.n_regions}), "
          f"max|err| = {e:.2e}")
    rep = get_backend("simulator").report(tiled.with_backend("simulator"))
    t = rep.traffic
    print(f"  tier traffic: L1 {t.l1_bytes / 1e3:.0f} kB, "
          f"L2 {t.l2_bytes / 1e3:.0f} kB, DRAM {t.dram_bytes / 1e3:.0f} kB "
          f"(merge {t.merge_bytes / 1e3:.1f} kB) over {t.tiles} tiles")

    print("== mixed-dataflow tiles: dataflow becomes a per-tile decision ==")
    ah = np.zeros((96, 96), np.float32)
    ah[:48] = rng.standard_normal((48, 96)).astype(np.float32)
    ah[48:] = random_sparse_dense(rng, (48, 96), density=0.5,
                                  block_shape=(8, 8))
    bh = random_sparse_dense(rng, (96, 96), density=0.9, block_shape=(8, 8))
    ah_t, bh_t = (torch.as_tensor(v, device=device) for v in (ah, bh))
    hbudget = MemoryBudget(l1_bytes=20000, l2_bytes=40000)
    mixed = flexagon_plan(ah_t, bh_t, dataflow="mixed", block_shape=(8, 8, 8),
                          memory_budget=hbudget, policy="simulator",
                          backend="simulator", device=device)
    assert isinstance(mixed, TiledPlan) and mixed.dataflow == "mixed"
    e = _err(mixed.apply(ah_t, bh_t),
             ah.astype(np.float64) @ bh.astype(np.float64))
    worst = max(worst, e)
    print(f"  per-tile choices over {mixed.n_tiles} tiles: "
          f"{mixed.tile_histogram}, max|err| = {e:.2e}")
    sim_be = get_backend("simulator")
    mixed_s = sim_be.report(mixed).traffic.time_s(sim_be.cfg)
    singles = {}
    for d in DATAFLOWS:
        p = flexagon_plan(ah_t, bh_t, dataflow=d, block_shape=(8, 8, 8),
                          memory_budget=hbudget, backend="simulator",
                          device=device)
        r = sim_be.report(p)
        singles[d] = r.traffic.time_s(sim_be.cfg) if isinstance(p, TiledPlan) \
            else r.cycles / sim_be.cfg.freq_hz
    best_d = min(singles, key=singles.get)
    print(f"  simulator pricing: mixed {mixed_s * 1e6:.2f} us <= best "
          f"single {best_d!r} {singles[best_d] * 1e6:.2f} us")
    assert mixed_s <= singles[best_d] * (1 + 1e-9)

    print("== observability: trace the plan lifecycle ==")
    obs.enable()
    try:
        traced = flexagon_plan(ah_t, bh_t, dataflow="mixed",
                               block_shape=(8, 8, 8), memory_budget=hbudget,
                               policy="simulator", backend="simulator",
                               device=device)
        for _ in range(10):
            traced.apply(ah_t, bh_t)
        spans = len(obs.get_tracer().to_chrome()["traceEvents"])
        reg = obs.get_registry()
        print(f"  {spans} trace events; plan.builds="
              f"{reg.value('plan.builds'):.0f}, select_tile p99 "
              f"{reg.get('policy.select_tile_s').quantile(0.99) * 1e6:.0f} us")
    finally:
        obs.disable()

    print("== distributed: mesh= partitions the plan into shards ==")
    mesh = make_virtual_mesh(8, device)
    sharded = flexagon_plan(a, b, dataflow="op_m", block_shape=(16, 16, 16),
                            mesh=mesh, device=device)
    assert isinstance(sharded, ShardedPlan)
    e = _err(sharded.apply(a, b), oracle)
    worst = max(worst, e)
    print(f"  {sharded.dataflow!r} over {sharded.n_shards} shards "
          f"(axis {sharded.axis!r}, collective {sharded.collective!r}), "
          f"max|err| = {e:.2e}")
    rep = get_backend("simulator").report(sharded.with_backend("simulator"))
    print(f"  interconnect tier: {rep.traffic.ici_bytes / 1e3:.1f} kB "
          f"merge traffic across {rep.shards} shards")

    print("== cycle-level simulator (paper layer V0) ==")
    st = from_layer(PAPER_LAYERS["V0"])
    cycles = {name: simulate(name, st).cycles for name in ACCELERATORS}
    for name, c in cycles.items():
        print(f"  {name:12s} {c:12.0f} cycles")
    best_fixed = min(v for k, v in cycles.items() if k != "flexagon")
    assert cycles["flexagon"] <= best_fixed * 1.001
    print("  => Flexagon matches the best fixed-dataflow accelerator.")
    assert worst <= TOL, f"worst error {worst:.2e} > {TOL}"
    return {"worst_err": worst, "kernel_launches": kernel_launches}


if __name__ == "__main__":
    main()
