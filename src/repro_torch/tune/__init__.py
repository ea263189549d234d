"""``repro_torch.tune`` — learned dataflow selection + persistent autotune
DB, the port of ``repro.tune``.

The accurate selectors (``SimulatorPolicy``, ``AutotunePolicy``) price or
measure every candidate dataflow — milliseconds to seconds per pattern,
far too slow for per-request selection in ``ServeEngine``.  This package
closes the gap from both ends (ROADMAP: Misam arXiv 2406.10166, FlexNN
arXiv 2403.09026):

- :mod:`~repro_torch.tune.features` — one cheap fixed-length feature vector
  per :class:`repro_torch.backends.SelectionContext` (dims, occupancy
  histograms, band structure, budget/mesh context);
- :mod:`~repro_torch.tune.corpus` — sweep the slow policies over synthetic +
  model-config patterns to emit a labeled dataset (whole-operation *and*
  per-tile labels, so ``select`` and ``select_tile`` both train);
- :mod:`~repro_torch.tune.learned` — depth-bounded decision trees and
  their bagged forest (numpy) and a tiny MLP (trained in torch) behind
  :class:`~repro_torch.tune.learned.LearnedPolicy`
  (``policy="learned"``): microsecond selection with a confidence
  threshold that falls back to ``HeuristicPolicy`` when uncertain;
- :mod:`~repro_torch.tune.db` — :class:`~repro_torch.tune.db.TuneDB`, an
  append-only JSONL measurement database (file-lock-safe concurrent
  writers, compaction, read-through on miss) that ``AutotunePolicy``
  reads/writes through — a fleet shares one warm database and a fresh
  server starts hot.

CLI::

    python -m repro_torch.tune corpus --quick --out corpus.jsonl
    python -m repro_torch.tune fit    --corpus corpus.jsonl --out model.npz
    python -m repro_torch.tune eval   --corpus corpus.jsonl --model model.npz

Payoff gate (tests/test_torch_tune.py): the learned policy agrees with
``SimulatorPolicy`` on ≥90% of a held-out pattern set at ≥100× lower
selection latency.
"""
from .corpus import (corpus_matrices, generate_contexts, generate_corpus,
                     load_corpus, save_corpus, split_corpus, tile_contexts)
from .db import TuneDB, accelerator_hash, db_key
from .features import FEATURE_NAMES, N_FEATURES, context_features, \
    pattern_features, proxy_costs
from .learned import DecisionTreeModel, ForestModel, LearnedPolicy, \
    MLPModel, fit_examples

__all__ = [
    "FEATURE_NAMES",
    "N_FEATURES",
    "pattern_features",
    "context_features",
    "proxy_costs",
    "generate_contexts",
    "generate_corpus",
    "tile_contexts",
    "save_corpus",
    "load_corpus",
    "split_corpus",
    "corpus_matrices",
    "DecisionTreeModel",
    "ForestModel",
    "MLPModel",
    "LearnedPolicy",
    "fit_examples",
    "TuneDB",
    "db_key",
    "accelerator_hash",
]
