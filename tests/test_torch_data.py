"""The port's data pipeline against the JAX package's.

``repro_torch.data.pipeline`` is numpy, as the reference is: its batches
must be byte-equal to the reference's for every (seed, step, host), frames
included.  The rest mirrors ``tests/test_data_pipeline.py`` on the port.
"""
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import make_batch_iterator as jax_make_batch_iterator

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import (Prefetcher, SyntheticLM,
                                       make_batch_iterator)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed,host,frames", [(0, 0, None), (3, 1, None),
                                              (7, 2, 16), (11, 0, 24)])
def test_synthetic_lm_byte_equal_to_jax(seed, host, frames):
    kw = dict(vocab=97, batch=3, seq_len=12, seed=seed, host_id=host,
              num_hosts=4, frames_dim=frames)
    ours, ref = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    for step in (0, 1, 5, 1000):
        _same(ours.batch_at(step), ref.batch_at(step))


def test_train_config_matches_jax():
    assert TrainConfig() == TrainConfig(**vars(JaxTrainConfig()))
    assert [f for f in vars(TrainConfig())] == list(vars(JaxTrainConfig()))


@pytest.mark.parametrize("arch", ["smollm-360m", "seamless-m4t-large-v2"])
def test_batch_iterator_byte_equal_to_jax(arch):
    from repro.configs import get_config as jax_get_config

    tcfg = TrainConfig(global_batch=4, seq_len=8, seed=5)
    jt = JaxTrainConfig(global_batch=4, seq_len=8, seed=5)
    ours = make_batch_iterator(get_config(arch, smoke=True), tcfg,
                               host_id=1, num_hosts=2, start_step=2)
    ref = jax_make_batch_iterator(jax_get_config(arch, smoke=True), jt,
                                  host_id=1, num_hosts=2, start_step=2)
    try:
        for _ in range(3):
            _same(next(ours), next(ref))
    finally:
        ours.close()
        ref.close()


# -- tests/test_data_pipeline.py on the port -----------------------------------


def test_deterministic_per_step():
    src = SyntheticLM(vocab=64, batch=4, seq_len=16, seed=3)
    a = src.batch_at(7)
    b = src.batch_at(7)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = src.batch_at(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_targets_are_shifted_tokens():
    src = SyntheticLM(vocab=64, batch=2, seq_len=16, seed=0)
    b = src.batch_at(0)
    nxt = (31 * b["tokens"] + 7) % 64
    assert (b["targets"] == nxt).mean() > 0.8


def test_host_sharding_differs():
    a = SyntheticLM(vocab=64, batch=4, seq_len=8, seed=0, host_id=0,
                    num_hosts=2).batch_at(0)
    b = SyntheticLM(vocab=64, batch=4, seq_len=8, seed=0, host_id=1,
                    num_hosts=2).batch_at(0)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_resume_matches_uninterrupted():
    cfg = get_config("smollm-360m", smoke=True)
    tcfg = TrainConfig(global_batch=4, seq_len=8)
    it = make_batch_iterator(cfg, tcfg, start_step=0)
    stream = [next(it) for _ in range(6)]
    it.close()
    it2 = make_batch_iterator(cfg, tcfg, start_step=3)
    resumed = [next(it2) for _ in range(3)]
    it2.close()
    for a, b in zip(stream[3:], resumed):
        assert np.array_equal(a["tokens"], b["tokens"])


def test_encdec_batches_have_frames():
    cfg = get_config("seamless-m4t-large-v2", smoke=True)
    tcfg = TrainConfig(global_batch=2, seq_len=8)
    it = make_batch_iterator(cfg, tcfg)
    b = next(it)
    it.close()
    assert "frames" in b and b["frames"].shape[0] == 2


def test_prefetcher_drains_iterator():
    pf = Prefetcher(iter(range(5)), depth=2)
    assert list(pf) == [0, 1, 2, 3, 4]
