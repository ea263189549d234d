"""Learned dataflow selection — microsecond `select` at plan time.

The port of ``repro.tune.learned``.  Model families over the
:mod:`repro_torch.tune.features` vector, trained on a
:mod:`repro_torch.tune.corpus` labeled by the accurate-but-slow policies
(``SimulatorPolicy``, optionally ``AutotunePolicy``):

- :class:`DecisionTreeModel` — a depth-bounded CART (gini) in plain
  numpy.  The baseline: trivially serializable, inspectable, and its
  ``predict_proba`` is a few array lookups — the fastest inference path.
- :class:`ForestModel` — bootstrap-bagged trees; the default.  Tree and
  forest fits are numpy copies of the reference's and byte-equal to its
  fits on the same corpus;
- :class:`MLPModel` — a tiny MLP trained full-batch with Adam in torch
  (the reference trains it with ``jax.grad``), from the same numpy-seeded
  init; the fitted parameters are exported to numpy so *inference never
  touches torch* (no dispatch overhead on the per-request serving path),
  and arrays fitted by the reference load and predict here.

:class:`LearnedPolicy` wraps either behind the ``SelectionPolicy`` seam:
``select``/``select_tile`` extract features, mask the class distribution
to ``ctx.allowed``, and return the argmax — unless the model is absent,
the prediction falls outside ``ctx.allowed``, or its (renormalized)
confidence is below ``threshold``, in which case the policy falls back to
:class:`repro_torch.backends.policies.HeuristicPolicy` and counts it.  Models
save/load as a single ``.npz`` (feature layout + classes + arrays), and
refuse to load across a feature-layout change.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import obs
from ..backends.policies import HeuristicPolicy, SelectionPolicy
from ..core import dataflows as df
from .features import FEATURE_NAMES, N_FEATURES, context_features

__all__ = ["DecisionTreeModel", "ForestModel", "MLPModel", "LearnedPolicy",
           "fit_examples"]

#: Fixed class layout: models always predict over all six dataflows and
#: the policy masks to ``ctx.allowed`` at selection time.
CLASSES: Tuple[str, ...] = df.DATAFLOWS

#: allowed-tuple -> boolean class mask (selection-path memo).
_ALLOWED_MASKS: Dict[Tuple[str, ...], np.ndarray] = {}


# ---------------------------------------------------------------------------
# Depth-bounded CART — the serializable, inspectable baseline
# ---------------------------------------------------------------------------


class DecisionTreeModel:
    """CART classifier (gini, midpoint splits), depth-bounded.

    Stored as flat arrays (``feature``/``threshold``/``left``/``right``
    per node, class distribution per leaf) so ``predict_proba`` is a tight
    loop of array lookups and serialization is four ``np.save`` columns.
    """

    kind = "tree"

    def __init__(self, max_depth: int = 10, min_samples_leaf: int = 2):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.feature: np.ndarray = np.zeros(0, np.int32)   # -1 = leaf
        self.threshold: np.ndarray = np.zeros(0, np.float32)
        self.left: np.ndarray = np.zeros(0, np.int32)
        self.right: np.ndarray = np.zeros(0, np.int32)
        self.value: np.ndarray = np.zeros((0, len(CLASSES)), np.float32)

    # -- fitting ----------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTreeModel":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.int64)
        nodes: list = []            # (feature, threshold, left, right, dist)

        def dist_of(idx) -> np.ndarray:
            d = np.bincount(y[idx], minlength=len(CLASSES)).astype(np.float32)
            return d / max(d.sum(), 1.0)

        def gini(counts: np.ndarray) -> float:
            total = counts.sum()
            if total <= 0:
                return 0.0
            p = counts / total
            return float(1.0 - (p * p).sum())

        def best_split(idx) -> Optional[Tuple[int, float]]:
            ys = y[idx]
            base_counts = np.bincount(ys, minlength=len(CLASSES)).astype(
                np.float64)
            best = (0.0, None)
            n = len(idx)
            for f in range(X.shape[1]):
                xs = X[idx, f]
                order = np.argsort(xs, kind="stable")
                xs_s, ys_s = xs[order], ys[order]
                # class counts left of each candidate boundary
                onehot = np.zeros((n, len(CLASSES)), np.float64)
                onehot[np.arange(n), ys_s] = 1.0
                left_counts = np.cumsum(onehot, axis=0)
                boundaries = np.nonzero(xs_s[1:] > xs_s[:-1])[0]
                for b in boundaries:
                    nl = b + 1
                    nr = n - nl
                    if nl < self.min_samples_leaf \
                            or nr < self.min_samples_leaf:
                        continue
                    lc = left_counts[b]
                    rc = base_counts - lc
                    score = gini(base_counts) - (
                        nl / n * gini(lc) + nr / n * gini(rc))
                    if score > best[0] + 1e-12:
                        thr = 0.5 * (xs_s[b] + xs_s[b + 1])
                        best = (score, (f, float(thr)))
            return best[1]

        def build(idx, depth: int) -> int:
            node_id = len(nodes)
            nodes.append(None)
            split = None
            if depth < self.max_depth \
                    and len(idx) >= 2 * self.min_samples_leaf \
                    and len(np.unique(y[idx])) > 1:
                split = best_split(idx)
            if split is None:
                nodes[node_id] = (-1, 0.0, -1, -1, dist_of(idx))
                return node_id
            f, thr = split
            mask = X[idx, f] <= thr
            left_id = build(idx[mask], depth + 1)
            right_id = build(idx[~mask], depth + 1)
            nodes[node_id] = (f, thr, left_id, right_id, dist_of(idx))
            return node_id

        build(np.arange(len(y)), 0)
        self.feature = np.asarray([n[0] for n in nodes], np.int32)
        self.threshold = np.asarray([n[1] for n in nodes], np.float32)
        self.left = np.asarray([n[2] for n in nodes], np.int32)
        self.right = np.asarray([n[3] for n in nodes], np.int32)
        self.value = np.stack([n[4] for n in nodes]).astype(np.float32)
        return self

    # -- inference ----------------------------------------------------------
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        out = np.empty((X.shape[0], len(CLASSES)), np.float32)
        for i in range(X.shape[0]):
            node = 0
            while self.feature[node] >= 0:
                node = (self.left[node]
                        if X[i, self.feature[node]] <= self.threshold[node]
                        else self.right[node])
            out[i] = self.value[node]
        return out

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    # -- serialization -------------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"tree_feature": self.feature, "tree_threshold": self.threshold,
                "tree_left": self.left, "tree_right": self.right,
                "tree_value": self.value}

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> "DecisionTreeModel":
        model = cls(max_depth=int(meta.get("max_depth", 10)),
                    min_samples_leaf=int(meta.get("min_samples_leaf", 2)))
        model.feature = np.asarray(arrays["tree_feature"], np.int32)
        model.threshold = np.asarray(arrays["tree_threshold"], np.float32)
        model.left = np.asarray(arrays["tree_left"], np.int32)
        model.right = np.asarray(arrays["tree_right"], np.int32)
        model.value = np.asarray(arrays["tree_value"], np.float32)
        return model

    def meta(self) -> Dict[str, Any]:
        return {"max_depth": self.max_depth,
                "min_samples_leaf": self.min_samples_leaf}


# ---------------------------------------------------------------------------
# Bagged forest — variance reduction over the CART baseline
# ---------------------------------------------------------------------------


class ForestModel:
    """Bootstrap-bagged :class:`DecisionTreeModel`\\ s, probabilities
    averaged.

    A single depth-bounded CART fits the corpus to train accuracy 1.0 and
    its held-out agreement swings a few points with the split seed;
    averaging ~a dozen bootstrap replicas removes most of that variance
    (measured: +3–6 points held-out agreement over one tree).  Inference
    is ``n_trees`` array-lookup walks — still tens of microseconds.
    """

    kind = "forest"

    def __init__(self, n_trees: int = 12, max_depth: int = 14,
                 min_samples_leaf: int = 1, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.trees: list = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "ForestModel":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.int64)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_trees):
            idx = rng.integers(0, len(y), len(y))
            self.trees.append(DecisionTreeModel(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf).fit(X[idx], y[idx]))
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        out = self.trees[0].predict_proba(X)
        for tree in self.trees[1:]:
            out += tree.predict_proba(X)
        return out / len(self.trees)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for i, tree in enumerate(self.trees):
            out.update({f"f{i}_{k}": v for k, v in tree.to_arrays().items()})
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> "ForestModel":
        model = cls(n_trees=int(meta.get("n_trees", 12)),
                    max_depth=int(meta.get("max_depth", 14)),
                    min_samples_leaf=int(meta.get("min_samples_leaf", 1)),
                    seed=int(meta.get("seed", 0)))
        model.trees = []
        for i in range(model.n_trees):
            sub = {k[len(f"f{i}_"):]: v for k, v in arrays.items()
                   if k.startswith(f"f{i}_")}
            model.trees.append(DecisionTreeModel.from_arrays(sub, meta))
        return model

    def meta(self) -> Dict[str, Any]:
        return {"n_trees": self.n_trees, "max_depth": self.max_depth,
                "min_samples_leaf": self.min_samples_leaf, "seed": self.seed}


# ---------------------------------------------------------------------------
# Tiny MLP — trained with torch autograd, inference exported to numpy
# ---------------------------------------------------------------------------


class MLPModel:
    """Two-layer MLP over standardized features.

    Training is torch (full-batch Adam on softmax cross-entropy) on
    ``device`` (``None``: the card), from the reference's numpy-seeded init;
    the fitted weights are held as numpy arrays and ``predict_proba`` is
    two numpy matmuls — no torch dispatch on the selection path.
    """

    kind = "mlp"

    def __init__(self, hidden: int = 32, steps: int = 400, lr: float = 3e-3,
                 seed: int = 0, device=None):
        self.hidden = hidden
        self.steps = steps
        self.lr = lr
        self.seed = seed
        self.device = device
        self.params: Dict[str, np.ndarray] = {}
        self.mu = np.zeros(N_FEATURES, np.float32)
        self.sigma = np.ones(N_FEATURES, np.float32)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MLPModel":
        import torch

        from ..config import resolve_device

        dev = resolve_device(self.device)
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.int64)
        self.mu = X.mean(axis=0).astype(np.float32)
        self.sigma = (X.std(axis=0) + 1e-6).astype(np.float32)
        xs = torch.as_tensor((X - self.mu) / self.sigma, device=dev)
        yt = torch.as_tensor(y, device=dev)

        rng = np.random.default_rng(self.seed)
        scale1 = (2.0 / N_FEATURES) ** 0.5
        scale2 = (2.0 / self.hidden) ** 0.5
        init = {
            "w1": rng.standard_normal(
                (N_FEATURES, self.hidden)).astype(np.float32) * scale1,
            "b1": np.zeros(self.hidden, np.float32),
            "w2": rng.standard_normal(
                (self.hidden, len(CLASSES))).astype(np.float32) * scale2,
            "b2": np.zeros(len(CLASSES), np.float32),
        }
        params = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in init.items()}
        # the reference's update, spelled out: Adam with bias correction,
        # eps outside the square root
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        for t in range(1, self.steps + 1):
            h = torch.relu(xs @ params["w1"] + params["b1"])
            logits = h @ params["w2"] + params["b2"]
            loss = torch.nn.functional.cross_entropy(logits, yt)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[k] / (1 - b1 ** t)
                    vh = v[k] / (1 - b2 ** t)
                    p.sub_(self.lr * mh / (vh.sqrt() + eps))
        self.params = {k: p.detach().cpu().numpy()
                       for k, p in params.items()}
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        X = (np.asarray(X, np.float32) - self.mu) / self.sigma
        h = np.maximum(X @ self.params["w1"] + self.params["b1"], 0.0)
        logits = h @ self.params["w2"] + self.params["b2"]
        logits -= logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        out = {"mlp_mu": self.mu, "mlp_sigma": self.sigma}
        out.update({f"mlp_{k}": v for k, v in self.params.items()})
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> "MLPModel":
        model = cls(hidden=int(meta.get("hidden", 32)))
        model.mu = np.asarray(arrays["mlp_mu"], np.float32)
        model.sigma = np.asarray(arrays["mlp_sigma"], np.float32)
        model.params = {k[len("mlp_"):]: np.asarray(v)
                        for k, v in arrays.items()
                        if k.startswith("mlp_") and k not in ("mlp_mu",
                                                              "mlp_sigma")}
        return model

    def meta(self) -> Dict[str, Any]:
        return {"hidden": self.hidden, "steps": self.steps, "lr": self.lr,
                "seed": self.seed}


_MODEL_KINDS = {"tree": DecisionTreeModel, "forest": ForestModel,
                "mlp": MLPModel}


# ---------------------------------------------------------------------------
# LearnedPolicy — the SelectionPolicy seam over either model
# ---------------------------------------------------------------------------


class LearnedPolicy(SelectionPolicy):
    """Select a dataflow in microseconds from cheap pattern features.

    ``select`` and ``select_tile`` share one path: extract the feature
    vector, predict a class distribution, zero out dataflows outside
    ``ctx.allowed``, renormalize, and return the argmax — so a
    learned-policy plan's dataflow is in ``ctx.allowed`` *by
    construction* (the analysis verifier independently re-checks it).
    Falls back to the ``fallback`` policy (default
    :class:`HeuristicPolicy`) when no model is loaded, every allowed
    class has zero mass, or the renormalized confidence is below
    ``threshold`` — counted in ``fallbacks`` so serving telemetry shows
    how often the model abstains.

    **Budget-bearing whole-operation selects also fall back** (counted in
    ``budget_fallbacks``): under a memory budget the simulator prices
    candidates through the tile scheduler (a different cost model per
    candidate — milliseconds each), and the planner's real decisions
    there are the *per-tile* ones, which the model does serve
    (``select_tile`` contexts are budget-free by construction).  Guessing
    the whole-operation tiled winner from microsecond features measured
    ~45% agreement in the reference, so the policy refuses to.
    """

    name = "learned"

    def __init__(self, model: Optional[Any] = None, threshold: float = 0.4,
                 fallback: Optional[SelectionPolicy] = None):
        self.model = model
        self.threshold = threshold
        self.fallback = fallback if fallback is not None else \
            HeuristicPolicy()
        self.selections = 0
        self.fallbacks = 0
        self.budget_fallbacks = 0

    # -- selection ---------------------------------------------------------
    def _predict(self, ctx) -> Optional[str]:
        if self.model is None:
            return None
        x = context_features(ctx)
        probs = self.model.predict_proba(x[None])[0]
        allowed = tuple(ctx.allowed)
        mask = _ALLOWED_MASKS.get(allowed)
        if mask is None:
            mask = np.asarray([c in allowed for c in CLASSES])
            _ALLOWED_MASKS[allowed] = mask
        masked = np.where(mask, probs, 0.0)
        total = float(masked.sum())
        if total <= 0.0:
            return None
        if float(masked.max()) / total < self.threshold:
            return None
        return CLASSES[int(masked.argmax())]

    def select(self, ctx) -> str:
        self.selections += 1
        if ctx.memory_budget is not None:
            self.budget_fallbacks += 1
            obs.get_registry().counter("policy.learned_fallbacks").inc()
            return self.fallback.select(ctx)
        choice = self._predict(ctx)
        if choice is None:
            self.fallbacks += 1
            obs.get_registry().counter("policy.learned_fallbacks").inc()
            return self.fallback.select(ctx)
        return choice

    def select_tile(self, ctx) -> str:
        self.selections += 1
        choice = self._predict(ctx)
        if choice is None:
            self.fallbacks += 1
            obs.get_registry().counter("policy.learned_fallbacks").inc()
            return self.fallback.select_tile(ctx)
        return choice

    @property
    def stats(self) -> Dict[str, Any]:
        base = dict(super().stats)
        base.update({
            "model": getattr(self.model, "kind", None),
            "threshold": self.threshold,
            "selections": self.selections,
            "fallbacks": self.fallbacks,
            "budget_fallbacks": self.budget_fallbacks,
            "fallback_policy": self.fallback.name,
        })
        return base

    # -- artifacts -----------------------------------------------------------
    def save(self, path: str) -> None:
        """One ``.npz``: model arrays + a JSON meta blob (kind, classes,
        feature layout, threshold) — self-describing and versionable."""
        if self.model is None:
            raise ValueError("no model to save: fit or load one first")
        meta = {"version": 1, "kind": self.model.kind,
                "classes": list(CLASSES),
                "feature_names": list(FEATURE_NAMES),
                "threshold": self.threshold,
                "model_meta": self.model.meta()}
        arrays = dict(self.model.to_arrays())
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str,
             fallback: Optional[SelectionPolicy] = None) -> "LearnedPolicy":
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays.pop("meta_json")).decode())
        if tuple(meta["feature_names"]) != FEATURE_NAMES:
            raise ValueError(
                f"model at {path!r} was fitted against a different feature "
                f"layout ({len(meta['feature_names'])} features vs "
                f"{N_FEATURES} expected); re-fit with "
                "`python -m repro_torch.tune`")
        if tuple(meta["classes"]) != CLASSES:
            raise ValueError(f"model at {path!r} predicts classes "
                             f"{meta['classes']}, expected {list(CLASSES)}")
        model = _MODEL_KINDS[meta["kind"]].from_arrays(
            arrays, meta.get("model_meta", {}))
        return cls(model=model, threshold=float(meta.get("threshold", 0.4)),
                   fallback=fallback)


def fit_examples(examples, model: str = "forest", *, threshold: float = 0.4,
                 max_depth: int = 14, min_samples_leaf: int = 1,
                 n_trees: int = 12, hidden: int = 32, steps: int = 400,
                 lr: float = 3e-3, seed: int = 0,
                 fallback: Optional[SelectionPolicy] = None,
                 device=None) -> LearnedPolicy:
    """Fit a :class:`LearnedPolicy` on corpus examples (tree/forest/MLP).

    ``device`` is where an MLP trains (``None``: the card); trees and
    forests fit in numpy on the host."""
    from .corpus import corpus_matrices

    X, y = corpus_matrices(examples)
    if model == "tree":
        fitted = DecisionTreeModel(max_depth=max_depth,
                                   min_samples_leaf=min_samples_leaf
                                   ).fit(X, y)
    elif model == "forest":
        fitted = ForestModel(n_trees=n_trees, max_depth=max_depth,
                             min_samples_leaf=min_samples_leaf,
                             seed=seed).fit(X, y)
    elif model == "mlp":
        fitted = MLPModel(hidden=hidden, steps=steps, lr=lr,
                          seed=seed, device=device).fit(X, y)
    else:
        raise ValueError(f"unknown model kind {model!r}; "
                         "expected 'tree', 'forest', or 'mlp'")
    return LearnedPolicy(model=fitted, threshold=threshold,
                         fallback=fallback)
