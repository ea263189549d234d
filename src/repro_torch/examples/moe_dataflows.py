"""The paper's thesis inside the LM framework: MoE dispatch as SpMSpM with
three selectable dataflows.

Runs one MoE layer under the einsum (IP-analogue), scatter (OP-analogue) and
sort (Gust-analogue, the grouped-matmul kernel K3 on the card) dispatch
strategies across several token counts: all three agree numerically, their
costs diverge the way the paper's dataflows do, and the phase-1 selector
picks per shape.  The port of ``examples/moe_dataflows.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.moe_dataflows
      [--device cpu] [--tokens 64 1024 8192]
"""
import argparse

import torch

from .. import obs
from ..configs.base import ModelConfig, MoEConfig
from ..kernels import moe_gmm
from ..models.moe import moe_apply, moe_init, select_moe_strategy

STRATEGIES = ("einsum", "scatter", "sort")
REPS = 3
#: the example's MoE layer (the reference example's)
CFG = ModelConfig(
    name="demo", family="moe", n_layers=1, d_model=256, n_heads=4,
    d_ff=512, vocab=1024,
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=2.0))


def bench(fn, device, reps=REPS):
    """(output, ms per call) over ``reps`` calls after one warm call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = obs.now_ns()
    for _ in range(reps):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (obs.now_ns() - t0) / reps / 1e6


def run_strategies(params, x, device):
    """One MoE layer on ``x`` (1, T, d_model) under each strategy: per
    strategy its output, ms per call and K3 launches per call."""
    outs, times, launches = {}, {}, {}
    for strat in STRATEGIES:
        before = moe_gmm.gmm.launches
        outs[strat], times[strat] = bench(
            lambda s=strat: moe_apply(params, CFG, x, strategy=s), device)
        launches[strat] = (moe_gmm.gmm.launches - before) / (REPS + 1)
    return outs, times, launches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, nargs="+", default=[64, 1024, 8192])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe_init(gen, CFG)

    rows = []
    for tokens in args.tokens:
        x = torch.randn((1, tokens, CFG.d_model), generator=gen,
                        device=device).to(torch.bfloat16)
        outs, times, launches = run_strategies(params, x, device)
        ref = outs["scatter"].float()
        scale = float(ref.abs().max())
        errs = {s: float((o.float() - ref).abs().max()) / scale
                for s, o in outs.items()}
        sel = select_moe_strategy(tokens, CFG.d_model, CFG.d_ff,
                                  CFG.moe.num_experts, CFG.moe.top_k)
        print(f"T={tokens:6d}: "
              + "  ".join(f"{s}={times[s]:7.2f}ms(rel err {errs[s]:.0e})"
                          for s in STRATEGIES)
              + f"   selector -> {sel}; K3 launches per sort call "
              f"{launches['sort']:g}")
        rows.append({"tokens": tokens, "ms": times, "rel_err": errs,
                     "k3_per_call": launches["sort"], "selector": sel})
    print("(same computation, three loop orders, shape-dependent winner — "
          "the Flexagon observation, alive in an LLM)")
    return rows


if __name__ == "__main__":
    main()
