"""The port's tune package against the JAX package's, and its payoff gates.

Parity, on the same seeded inputs: feature vectors, corpus records and
tree/forest fits are byte-equal to ``repro.tune``'s; an MLP fitted by the
JAX package predicts the same probabilities (1e-6) when its arrays load
into the port; ``db_key`` re-derives byte-equal across processes and
equals JAX's without a placement.  Then the reference's gates on the port
(``tests/test_tune.py``): >= 90% held-out agreement with
``SimulatorPolicy``, >= 100x lower select latency, one shared ``TuneDB``
sweep; the ``TuneDB`` itself; ``LearnedPolicy``'s fallbacks and artifacts;
and the ``python -m repro_torch.tune`` CLI.  Everything runs on the CPU.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.backends import get_backend as jax_get_backend
from repro.backends.policies import SelectionContext as JaxContext
from repro.core.selector import LayerShape as JaxLayerShape
from repro.core.selector import TPUSpec
from repro.memory import MemoryBudget as JaxBudget
from repro.tune import context_features as jax_context_features
from repro.tune import corpus_matrices as jax_corpus_matrices
from repro.tune import db_key as jax_db_key
from repro.tune import fit_examples as jax_fit_examples
from repro.tune import generate_corpus as jax_generate_corpus

from repro_torch import MemoryBudget
from repro_torch.backends import (AutotunePolicy, HeuristicPolicy,
                                  SelectionContext, SimulatorPolicy,
                                  allowed_dataflows, get_backend, get_policy)
from repro_torch.core.dataflows import DATAFLOWS
from repro_torch.core.selector import DeviceSpec, LayerShape
from repro_torch.tune import (FEATURE_NAMES, N_FEATURES, LearnedPolicy,
                              TuneDB, accelerator_hash, context_features,
                              corpus_matrices, db_key, fit_examples,
                              generate_contexts, generate_corpus,
                              load_corpus, proxy_costs, save_corpus,
                              split_corpus)
from repro_torch.tune.learned import CLASSES, MLPModel

ROOT = Path(__file__).resolve().parents[1]
BS = (16, 16, 16)


def _occupancy(m, k, n, da, db, seed):
    rng = np.random.default_rng(seed)
    bm, bk, bn = BS
    occ_a = rng.random((m // bm, k // bk)) < da
    occ_b = rng.random((k // bk, n // bn)) < db
    occ_a[0, 0] = occ_b[0, 0] = True          # never a fully-empty operand
    return occ_a, occ_b


def _context(m=64, k=64, n=96, da=0.5, db=0.6, seed=0, budget=None,
             allowed=None, backend="reference"):
    """One port SelectionContext on a seeded random block pattern."""
    be = get_backend(backend)
    occ_a, occ_b = _occupancy(m, k, n, da, db, seed)
    shape = LayerShape(m, k, n, float(occ_a.mean()), float(occ_b.mean()),
                       block=BS)
    return SelectionContext(
        shape=shape, block_shape=BS, occ_a=occ_a, occ_b=occ_b,
        fingerprint=f"test:{m}x{k}x{n}:{da}:{db}:{seed}",
        backend=be, spec=DeviceSpec(),
        allowed=tuple(allowed) if allowed else allowed_dataflows(be, BS),
        memory_budget=MemoryBudget(*budget) if budget else None,
        device="cpu")


def _jax_context(m=64, k=64, n=96, da=0.5, db=0.6, seed=0, budget=None):
    be = jax_get_backend("reference")
    occ_a, occ_b = _occupancy(m, k, n, da, db, seed)
    shape = JaxLayerShape(m, k, n, float(occ_a.mean()),
                          float(occ_b.mean()), block=BS)
    return JaxContext(shape=shape, block_shape=BS, occ_a=occ_a,
                      occ_b=occ_b, fingerprint="test", backend=be,
                      spec=TPUSpec(), allowed=DATAFLOWS,
                      memory_budget=JaxBudget(*budget) if budget else None)


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("budget", [None, (4 << 10, 8 << 10)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_byte_equal(seed, budget):
    kw = dict(m=64 + 32 * seed, k=128, n=96, da=0.3 + 0.2 * seed,
              db=0.7 - 0.2 * seed, seed=seed, budget=budget)
    mine = context_features(_context(**kw))
    theirs = jax_context_features(_jax_context(**kw))
    assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()


@pytest.fixture(scope="module")
def small_corpus():
    return generate_corpus(n_synthetic=60, quick=True, seed=3,
                           min_margin=0.1)


def test_corpus_byte_equal(small_corpus):
    """The quick corpus, records and features, is JAX's record for record
    (labels from the port's SimulatorPolicy)."""
    theirs = jax_generate_corpus(n_synthetic=60, quick=True, seed=3,
                                 min_margin=0.1)
    assert json.dumps(small_corpus) == json.dumps(theirs)
    assert corpus_matrices(small_corpus)[0].tobytes() \
        == jax_corpus_matrices(theirs)[0].tobytes()


@pytest.mark.parametrize("block", [(16, 16, 16), (32, 32, 32)])
def test_full_corpus_config_specs_equal_jax(block):
    """The full (not ``quick``) corpus's config-derived specs equal JAX's
    spec for spec: every arch of ``CONFIG_ARCHS`` is registered in the
    port, mixtral-8x7b included."""
    from repro.tune import corpus as jax_corpus
    from repro_torch.tune import corpus as port_corpus

    assert port_corpus.CONFIG_ARCHS == jax_corpus.CONFIG_ARCHS
    mine = [s.meta() for s in port_corpus._config_specs(
        np.random.default_rng(11), quick=False, block_shape=block)]
    theirs = [s.meta() for s in jax_corpus._config_specs(
        np.random.default_rng(11), quick=False, block_shape=block)]
    assert mine == theirs
    origins = {m["origin"].split(":")[1] for m in mine}
    assert origins == set(jax_corpus.CONFIG_ARCHS)


@pytest.mark.parametrize("kind", ["tree", "forest"])
def test_fits_byte_equal(small_corpus, kind):
    mine = fit_examples(small_corpus, model=kind, n_trees=4).model
    theirs = jax_fit_examples(small_corpus, model=kind, n_trees=4).model
    a, b = mine.to_arrays(), theirs.to_arrays()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_mlp_predicts_from_jax_fitted_arrays(small_corpus, tmp_path):
    """JAX fits the MLP; its saved artifact loads into the port, whose
    numpy inference agrees to 1e-6."""
    theirs = jax_fit_examples(small_corpus, model="mlp", steps=60)
    path = str(tmp_path / "jax_mlp.npz")
    theirs.save(path)
    mine = LearnedPolicy.load(path)
    assert isinstance(mine.model, MLPModel)
    X, _ = corpus_matrices(small_corpus)
    np.testing.assert_allclose(mine.model.predict_proba(X),
                               theirs.model.predict_proba(X), atol=1e-6,
                               rtol=0)


def test_mlp_fit_in_torch_tracks_jax(small_corpus):
    """The port trains the same MLP (same numpy init, Adam, steps) with
    torch autograd: its train-set predictions agree with JAX's fit."""
    X, y = corpus_matrices(small_corpus)
    mine = MLPModel(steps=60, device="cpu").fit(X, y)
    theirs = jax_fit_examples(small_corpus, model="mlp", steps=60).model
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(mine.params[k], theirs.params[k],
                                   atol=1e-4, rtol=1e-4)
    assert (mine.predict_proba(X).argmax(1)
            == theirs.predict_proba(X).argmax(1)).mean() >= 0.98


DB_CASES = [
    ("fp:abc", "reference", (16, 16, 16), None),
    ("fp:xyz/tile3", "cuda", (32, 16, 8), (4096, 8192)),
    ("shape:64x64x96:0.5000:0.6000:b16x16x16:float32",
     "simulator", (16, 16, 16), None),
]


def test_db_key_equals_jax_without_placement():
    for fp, be, bs, budget in DB_CASES:
        mine = db_key(fp, be, bs, memory_budget=MemoryBudget(*budget)
                      if budget else None, accel={"num_multipliers": 64})
        theirs = jax_db_key(fp, be, bs, memory_budget=JaxBudget(*budget)
                            if budget else None,
                            accel={"num_multipliers": 64})
        assert mine == theirs
    assert db_key("fp", "cuda", BS, accel="NVIDIA H100 80GB HBM3") \
        != db_key("fp", "cuda", BS)
    assert db_key("fp", "cuda", BS, placement=("single",)) \
        != db_key("fp", "cuda", BS)


def test_db_key_stable_cross_process():
    """The durable key re-derives bit-identically in a fresh interpreter
    with another hash seed — the fleet-sharing contract."""
    local = [db_key(fp, be, bs, memory_budget=MemoryBudget(*budget)
                    if budget else None, accel={"num_multipliers": 64},
                    placement=("process", "cuda", (0, 1), "0"))
             for fp, be, bs, budget in DB_CASES]
    child = (
        "import json, sys\n"
        "from repro_torch.memory import MemoryBudget\n"
        "from repro_torch.tune.db import db_key\n"
        "out = []\n"
        "for fp, be, bs, budget in json.loads(sys.argv[1]):\n"
        "    mb = MemoryBudget(*budget) if budget else None\n"
        "    out.append(db_key(fp, be, tuple(bs), memory_budget=mb,\n"
        "               accel={'num_multipliers': 64},\n"
        "               placement=('process', 'cuda', (0, 1), '0')))\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED="12345")
    proc = subprocess.run([sys.executable, "-c", child,
                           json.dumps(DB_CASES)],
                          check=True, capture_output=True, text=True,
                          env=env)
    assert json.loads(proc.stdout) == local


def test_accelerator_hash_stable_and_discriminating():
    from repro_torch.core.simulator.config import PAPER_CONFIG

    h = accelerator_hash(PAPER_CONFIG)
    assert h == accelerator_hash(PAPER_CONFIG) and len(h) == 16
    assert accelerator_hash(None) == "-"
    assert accelerator_hash({"a": 1}) != accelerator_hash({"a": 2})
    assert accelerator_hash({"a": 1, "b": 2}) == \
        accelerator_hash({"b": 2, "a": 1})


# -- payoff gate, on the port ---------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    """(policy, train, held_out): quick corpus, margin-filtered labels,
    grouped split, bagged forest — the reference's gate configuration."""
    examples = generate_corpus(n_synthetic=1600, quick=True, seed=0,
                               min_margin=0.1)
    train, held_out = split_corpus(examples, held_out=0.2, seed=0)
    policy = fit_examples(train, model="forest")
    return policy, train, held_out


def test_gate_agreement_90pct(fitted):
    """(a) >= 90% held-out agreement with the simulator's labels."""
    policy, _, held_out = fitted
    assert len(held_out) >= 100
    X, y = corpus_matrices(held_out)
    pred = policy.model.predict_proba(X).argmax(axis=1)
    agreement = float((pred == y).mean())
    assert agreement >= 0.90, f"held-out agreement {agreement:.3f} < 0.90"


def test_gate_latency_100x(fitted):
    """(b) median select latency >= 100x below the simulator's, on large
    no-budget grids (the ratio, not the times, is asserted)."""
    policy = fitted[0]
    sim = SimulatorPolicy()
    contexts = [c for c, _ in generate_contexts(
        40, quick=False, seed=7, max_grid=64, include_configs=False,
        budget_fraction=0.0)
        if min(c.occ_a.shape[0], c.occ_a.shape[1], c.occ_b.shape[1]) >= 32
    ][:5]
    assert len(contexts) == 5
    sim_t, learned_t = [], []
    for ctx in contexts:
        t0 = time.perf_counter()
        sim.select(ctx)
        sim_t.append(time.perf_counter() - t0)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            policy.select(ctx)
            best = min(best, time.perf_counter() - t0)
        learned_t.append(best)
    ratio = float(np.median(sim_t)) / max(float(np.median(learned_t)), 1e-9)
    assert ratio >= 100.0, (
        f"simulator {np.median(sim_t) * 1e3:.1f}ms vs learned "
        f"{np.median(learned_t) * 1e6:.0f}us = {ratio:.0f}x < 100x")


def test_gate_shared_db_one_sweep(tmp_path):
    """(c) two AutotunePolicy instances, one DB path, one sweep total."""
    path = str(tmp_path / "tune_db.jsonl")
    ctx = _context(m=32, k=32, n=32, allowed=("ip_m", "gust_m"))
    p1 = AutotunePolicy(reps=1, db=path)
    p2 = AutotunePolicy(reps=1, db=path)
    c1 = p1.select(ctx)
    c2 = p2.select(ctx)
    assert c1 == c2
    assert p1.measurements + p2.measurements == 1
    assert p2.db_hits == 1 and p2.measurements == 0
    p3 = AutotunePolicy(reps=1, db=path)
    assert p3.select(ctx) == c1 and p3.measurements == 0
    assert p3.stats["db_hits"] == 1 and p3.stats["db"]["entries"] == 1


def test_autotune_db_keys_carry_placement_and_knobs(tmp_path):
    """A mesh's placement splits the durable key, and a disk hit re-applies
    the knob values the sweep chose."""
    from repro_torch.backends import CudaBackend
    from repro_torch.backends.base import _REGISTRY
    from repro_torch.launch.mesh import make_virtual_mesh

    path = str(tmp_path / "db.jsonl")
    be = CudaBackend()
    be.name = "cuda-tune-test"
    _REGISTRY[be.name] = be
    try:
        ctx = _context(m=32, k=32, n=32, backend=be.name,
                       allowed=("ip_m", "gust_m"))
        pol = AutotunePolicy(reps=1, db=path)
        choice = pol.select(ctx)
        knob = be.dense_threshold
        be.dense_threshold = 0.5
        fresh = AutotunePolicy(reps=1, db=path)
        assert fresh.select(ctx) == choice and fresh.measurements == 0
        assert be.dense_threshold == knob
        meshed = SelectionContext(**{**ctx.__dict__,
                                     "mesh": make_virtual_mesh(1, "cpu")})
        assert fresh._db_key(meshed) != fresh._db_key(ctx)
    finally:
        _REGISTRY.pop(be.name)


def test_autotune_db_on_a_process_mesh(tmp_path):
    """On a process-group mesh the ranks take the first rank's DB record
    (a broadcast), so they all hit or all measure; one gloo rank here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
        ctx = SelectionContext(**{**_context(m=32, k=32, n=32, allowed=(
            "ip_m", "gust_m")).__dict__, "mesh": mesh})
        path = str(tmp_path / "db.jsonl")
        choice = AutotunePolicy(reps=1, db=path).select(ctx)
        again = AutotunePolicy(reps=1, db=path)
        assert again.select(ctx) == choice
        assert again.db_hits == 1 and again.measurements == 0
        local = AutotunePolicy(reps=1, db=path)
        plain = SelectionContext(**{**ctx.__dict__, "mesh": None})
        assert local._db_key(plain) != again._db_key(ctx)
    finally:
        dist.destroy_process_group()


def test_autotune_select_block_persists(tmp_path):
    path = str(tmp_path / "db.jsonl")
    ctx = _context(m=32, k=32, n=32)
    cands = ((8, 8, 8), (16, 16, 16))
    best = AutotunePolicy(reps=1, db=path).select_block(ctx, cands)
    again = AutotunePolicy(reps=1, db=path)
    assert again.select_block(ctx, cands) == best
    assert again.measurements == 0 and again.db_hits == 1


def test_autotune_db_from_env(tmp_path, monkeypatch):
    path = str(tmp_path / "env_db.jsonl")
    monkeypatch.setenv("REPRO_TUNE_DB", path)
    pol = AutotunePolicy(reps=1)
    assert pol.db is not None and pol.db.path == path
    monkeypatch.delenv("REPRO_TUNE_DB")
    assert AutotunePolicy(reps=1).db is None


# -- TuneDB: durable, shared, compactable ---------------------------------------

def test_tunedb_roundtrip_across_instances(tmp_path):
    path = str(tmp_path / "db.jsonl")
    a, b = TuneDB(path), TuneDB(path)
    a.put("k1", {"choice": "ip_m"})
    assert b.get("k1")["choice"] == "ip_m"
    b.put("k2", {"choice": "op_n"})
    assert a.get("k2")["choice"] == "op_n"
    assert len(a) == 2 and "k1" in b
    assert a.get("nope") is None and a.misses >= 1


def test_tunedb_compaction_keeps_newest(tmp_path):
    path = str(tmp_path / "db.jsonl")
    db = TuneDB(path)
    for i in range(10):
        db.put("k", {"choice": f"c{i}"})
    assert db.compact() == 9
    assert db.get("k")["choice"] == "c9"
    fresh = TuneDB(path)
    assert len(fresh) == 1 and fresh.get("k")["choice"] == "c9"


def test_tunedb_auto_compacts_dominated_files(tmp_path):
    path = str(tmp_path / "db.jsonl")
    db = TuneDB(path, compact_above=4)
    for i in range(12):
        db.put("k", {"choice": f"c{i}"})
    with open(path) as f:
        lines = sum(1 for _ in f)
    assert lines < 12 and db.get("k")["choice"] == "c11"


def test_tunedb_concurrent_writer_process(tmp_path):
    """Appends from another process are visible without re-opening, and a
    file the JAX package wrote reads back here."""
    path = str(tmp_path / "db.jsonl")
    db = TuneDB(path)
    db.put("mine", {"choice": "ip_m"})
    child = (
        "from repro.tune.db import TuneDB\n"
        f"db = TuneDB({path!r})\n"
        "for i in range(20):\n"
        "    db.put(f'child{i}', {'choice': 'gust_n'})\n"
        "assert db.get('mine')['choice'] == 'ip_m'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", child], check=True, env=env)
    assert db.get("child19")["choice"] == "gust_n"
    assert len(db) == 21


def test_tunedb_tolerates_torn_line(tmp_path):
    path = str(tmp_path / "db.jsonl")
    db = TuneDB(path)
    db.put("good", {"choice": "ip_m"})
    with open(path, "a") as f:
        f.write('{"key": "torn", "choi')
    fresh = TuneDB(path)
    assert fresh.get("good")["choice"] == "ip_m"
    assert fresh.get("torn") is None


# -- features and corpus ---------------------------------------------------------

def test_feature_vector_layout_and_determinism():
    ctx = _context()
    f1, f2 = context_features(ctx), context_features(ctx)
    assert f1.shape == (N_FEATURES,) == (len(FEATURE_NAMES),)
    assert np.array_equal(f1, f2) and np.isfinite(f1).all()


def test_proxy_costs_positive_and_mn_dual():
    pc = proxy_costs(128, 256, 64, 0.3, 0.7)
    assert set(pc) == set(DATAFLOWS)
    assert all(v > 0 for v in pc.values())
    dual = proxy_costs(64, 256, 128, 0.7, 0.3)
    for base in ("ip", "op", "gust"):
        assert pc[base + "_n"] == pytest.approx(dual[base + "_m"])


def test_corpus_records_and_roundtrip(small_corpus, tmp_path):
    assert len(small_corpus) > 20
    for ex in small_corpus:
        assert ex["label"] in DATAFLOWS
        assert len(ex["features"]) == N_FEATURES
        assert ex["margin"] is None or ex["margin"] >= 0.1
    assert all(ex["budget"] is None
               for ex in small_corpus if ex["kind"] == "whole")
    path = str(tmp_path / "corpus.jsonl")
    save_corpus(path, small_corpus)
    again = load_corpus(path)
    assert [ex["label"] for ex in again] == \
        [ex["label"] for ex in small_corpus]


def test_split_corpus_grouped_no_leak(small_corpus):
    train, held_out = split_corpus(small_corpus, held_out=0.3, seed=0)
    assert len(train) + len(held_out) == len(small_corpus)
    assert not ({ex["group"] for ex in train}
                & {ex["group"] for ex in held_out})


# -- LearnedPolicy ---------------------------------------------------------------

def test_learned_save_load_roundtrip(fitted, tmp_path):
    policy = fitted[0]
    path = str(tmp_path / "model.npz")
    policy.save(path)
    again = LearnedPolicy.load(path)
    assert again.model.kind == policy.model.kind
    assert again.threshold == policy.threshold
    X, _ = corpus_matrices(fitted[2][:32])
    np.testing.assert_allclose(policy.model.predict_proba(X),
                               again.model.predict_proba(X), atol=1e-6)
    ctx = _context(seed=11)
    assert again.select(ctx) == policy.select(ctx)


def test_learned_mlp_roundtrip(small_corpus, tmp_path):
    policy = fit_examples(small_corpus, model="mlp", steps=60, device="cpu")
    path = str(tmp_path / "mlp.npz")
    policy.save(path)
    again = LearnedPolicy.load(path)
    X, _ = corpus_matrices(small_corpus[:16])
    np.testing.assert_allclose(policy.model.predict_proba(X),
                               again.model.predict_proba(X), atol=1e-5)


def test_learned_respects_allowed(fitted):
    policy = fitted[0]
    for allowed in (("op_m", "op_n"), ("gust_m",), ("ip_n", "gust_n")):
        ctx = _context(seed=5, allowed=allowed)
        assert policy.select(ctx) in allowed
        assert policy.select_tile(ctx) in allowed


def test_learned_budget_fallback_is_structural(fitted):
    policy = fitted[0]
    before = policy.budget_fallbacks
    ctx = _context(budget=(4 << 10, 8 << 10))
    assert policy.select(ctx) == HeuristicPolicy().select(ctx)
    assert policy.budget_fallbacks == before + 1
    fb = policy.fallbacks
    policy.select_tile(_context(seed=6))
    assert policy.fallbacks == fb


def test_learned_modelless_and_threshold_fallback(fitted):
    ctx = _context(seed=9)
    bare = LearnedPolicy()
    assert bare.select(ctx) == HeuristicPolicy().select(ctx)
    assert bare.fallbacks == 1 and bare.stats["model"] is None
    timid = LearnedPolicy(model=fitted[0].model, threshold=1.01)
    assert timid.select(ctx) == HeuristicPolicy().select(ctx)
    assert timid.fallbacks == 1


def test_learned_refuses_foreign_layouts(fitted, tmp_path):
    path = str(tmp_path / "model.npz")
    fitted[0].save(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["feature_names"] = meta["feature_names"][:-1]
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="feature layout"):
        LearnedPolicy.load(path)


def test_get_policy_learned_loads_the_model(fitted, tmp_path, monkeypatch):
    """``policy="learned"`` loads ``REPRO_TUNE_MODEL`` once and plans with
    it; every pick is in the backend's allowed set."""
    from repro_torch import flexagon_plan
    from repro_torch.backends import policies

    path = str(tmp_path / "model.npz")
    fitted[0].save(path)
    monkeypatch.setenv("REPRO_TUNE_MODEL", path)
    monkeypatch.setattr(policies, "_NAMED", {})
    pol = get_policy("learned")
    assert isinstance(pol, LearnedPolicy) and pol.model is not None
    assert get_policy("learned") is pol
    rng = np.random.default_rng(4)
    a = (rng.random((64, 96)) < 0.5).astype(np.float32)
    b = (rng.random((96, 80)) < 0.5).astype(np.float32)
    plan = flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu",
                         policy="learned")
    assert plan.dataflow in DATAFLOWS and pol.selections == 1
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b, rtol=1e-4,
                               atol=1e-4)
    assert CLASSES == DATAFLOWS


# -- CLI -----------------------------------------------------------------------

def test_cli_corpus_fit_eval_roundtrip(tmp_path):
    from repro_torch.tune.__main__ import main

    corpus = str(tmp_path / "corpus.jsonl")
    model = str(tmp_path / "model.npz")
    assert main(["corpus", "--quick", "--n", "60", "--seed", "3",
                 "--out", corpus]) == 0
    size = os.path.getsize(corpus)
    assert main(["corpus", "--quick", "--n", "999", "--out", corpus,
                 "--skip-existing"]) == 0
    assert os.path.getsize(corpus) == size
    assert main(["fit", "--corpus", corpus, "--out", model,
                 "--model", "tree"]) == 0
    assert main(["eval", "--corpus", corpus, "--model", model,
                 "--min-agreement", "0.0"]) == 0
    assert main(["eval", "--corpus", corpus, "--model", model,
                 "--min-agreement", "1.01"]) == 1
    mlp = str(tmp_path / "mlp.npz")
    assert main(["fit", "--corpus", corpus, "--out", mlp, "--model", "mlp",
                 "--steps", "20", "--device", "cpu"]) == 0
    assert LearnedPolicy.load(mlp).model.kind == "mlp"
