"""CLI for the tune subsystem: ``python -m repro_torch.tune <corpus|fit|eval>``.

The port of ``python -m repro.tune``.

- ``corpus`` — sweep the labeling policy over synthetic + config patterns
  and write a JSONL corpus (``--skip-existing`` makes the step a no-op
  when a cached artifact is already present — the CI lane caches the
  corpus between runs);
- ``fit``    — fit the bagged-forest default, the single-tree baseline or
  the MLP (trained in torch, on ``--device``, default the card) on a
  corpus and save the model artifact (``.npz``);
- ``eval``   — held-out agreement of a fitted model against the corpus
  labels (and the model-vs-simulator selection-latency ratio with
  ``--latency``); exits nonzero below ``--min-agreement``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _cmd_corpus(args) -> int:
    from .corpus import generate_corpus, save_corpus

    if args.skip_existing and os.path.exists(args.out):
        print(f"corpus: {args.out} exists, skipping (cached artifact)")
        return 0
    examples = generate_corpus(
        n_synthetic=args.n, quick=args.quick, labeler=args.labeler,
        backend=args.backend, seed=args.seed,
        include_tiles=not args.no_tiles, min_margin=args.min_margin)
    save_corpus(args.out, examples)
    labels = {}
    for ex in examples:
        labels[ex["label"]] = labels.get(ex["label"], 0) + 1
    print(f"corpus: wrote {len(examples)} examples to {args.out} "
          f"(labeler={args.labeler}, labels={labels})")
    return 0


def _cmd_fit(args) -> int:
    from .corpus import load_corpus, split_corpus
    from .learned import fit_examples

    examples = load_corpus(args.corpus)
    train, _ = split_corpus(examples, held_out=args.held_out,
                            seed=args.split_seed)
    policy = fit_examples(train, model=args.model, threshold=args.threshold,
                          max_depth=args.max_depth, n_trees=args.trees,
                          hidden=args.hidden, steps=args.steps,
                          device=args.device)
    policy.save(args.out)
    print(f"fit: {args.model} on {len(train)} examples "
          f"({len(examples) - len(train)} held out) -> {args.out}")
    return 0


def _cmd_eval(args) -> int:
    from .corpus import corpus_matrices, load_corpus, split_corpus
    from .learned import CLASSES, LearnedPolicy

    policy = LearnedPolicy.load(args.model)
    examples = load_corpus(args.corpus)
    _, held_out = split_corpus(examples, held_out=args.held_out,
                               seed=args.split_seed)
    X, y = corpus_matrices(held_out)
    pred = policy.model.predict_proba(X).argmax(axis=1)
    agreement = float((pred == y).mean())
    conf = policy.model.predict_proba(X).max(axis=1)
    fallback_rate = float((conf < policy.threshold).mean())
    print(f"eval: held-out agreement {agreement:.3f} over {len(y)} examples "
          f"(threshold {policy.threshold} would abstain on "
          f"{fallback_rate:.1%})")
    per_class = {}
    for cls_idx, cls in enumerate(CLASSES):
        mask = y == cls_idx
        if mask.any():
            per_class[cls] = float((pred[mask] == cls_idx).mean())
    print(f"eval: per-label agreement {per_class}")

    if args.latency:
        from ..backends.policies import SimulatorPolicy
        from .corpus import generate_contexts

        # Large no-budget grids: the serving-relevant regime, where the
        # simulator has to sample and price big element patterns while the
        # learned path stays a fixed-cost feature extraction + tree walk.
        sim = SimulatorPolicy()
        contexts = [c for c, _ in generate_contexts(
            40, quick=False, seed=args.split_seed + 1, max_grid=64,
            include_configs=False, budget_fraction=0.0)
            if min(c.occ_a.shape[0], c.occ_a.shape[1],
                   c.occ_b.shape[1]) >= 32][:5]
        sim_t, learned_t = [], []
        for ctx in contexts:
            t0 = time.perf_counter()  # lint: time-ok (CLI-reported latency)
            sim.select(ctx)
            sim_t.append(time.perf_counter() - t0)  # lint: time-ok
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()  # lint: time-ok
                policy.select(ctx)
                best = min(best, time.perf_counter() - t0)  # lint: time-ok
            learned_t.append(best)
        ratio = float(np.median(sim_t) / max(np.median(learned_t), 1e-9))
        print(f"eval: median selection latency simulator "
              f"{np.median(sim_t) * 1e3:.1f}ms vs learned "
              f"{np.median(learned_t) * 1e6:.1f}us ({ratio:.0f}x)")

    if agreement < args.min_agreement:
        print(f"eval: FAILED — agreement {agreement:.3f} < "
              f"--min-agreement {args.min_agreement}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("corpus", help="generate a labeled corpus")
    c.add_argument("--out", default="tune_corpus.jsonl")
    c.add_argument("--n", type=int, default=120,
                   help="synthetic pattern count")
    c.add_argument("--quick", action="store_true",
                   help="small grids, fewer configs (CI smoke)")
    c.add_argument("--labeler", default="simulator",
                   help="labeling policy name (simulator/autotune/heuristic)")
    c.add_argument("--backend", default="reference")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--no-tiles", action="store_true",
                   help="skip per-tile (select_tile) examples")
    c.add_argument("--min-margin", type=float, default=0.1,
                   help="drop examples whose best-vs-second cost margin is "
                        "below this (near-ties are tie-break noise, not "
                        "signal)")
    c.add_argument("--skip-existing", action="store_true",
                   help="no-op when --out already exists (cached artifact)")
    c.set_defaults(fn=_cmd_corpus)

    f = sub.add_parser("fit", help="fit a model on a corpus")
    f.add_argument("--corpus", default="tune_corpus.jsonl")
    f.add_argument("--out", default="tune_model.npz")
    f.add_argument("--model", choices=("forest", "tree", "mlp"),
                   default="forest")
    f.add_argument("--max-depth", type=int, default=14)
    f.add_argument("--trees", type=int, default=12,
                   help="bag size for --model forest")
    f.add_argument("--hidden", type=int, default=32)
    f.add_argument("--steps", type=int, default=400)
    f.add_argument("--threshold", type=float, default=0.4)
    f.add_argument("--held-out", type=float, default=0.25)
    f.add_argument("--split-seed", type=int, default=0)
    f.add_argument("--device", default=None,
                   help="where an MLP trains (default: the card)")
    f.set_defaults(fn=_cmd_fit)

    e = sub.add_parser("eval", help="held-out agreement of a fitted model")
    e.add_argument("--corpus", default="tune_corpus.jsonl")
    e.add_argument("--model", default="tune_model.npz")
    e.add_argument("--held-out", type=float, default=0.25)
    e.add_argument("--split-seed", type=int, default=0)
    e.add_argument("--min-agreement", type=float, default=0.9)
    e.add_argument("--latency", action="store_true",
                   help="also report the selection-latency ratio vs the "
                        "simulator policy")
    e.set_defaults(fn=_cmd_eval)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
