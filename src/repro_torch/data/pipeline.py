"""Data pipeline: deterministic sharded synthetic token stream + prefetch.

The port of ``repro.data.pipeline``, numpy throughout and byte for byte the
reference's batches: the trainer moves each batch to the device.

Production posture: each host draws only its own shard of the global batch
(``host_id`` / ``num_hosts``), generation is a counter-based PRNG keyed on
(seed, step, host) so restarts resume bit-identically from a checkpointed
step — the property the fault-tolerance layer relies on.  A background
prefetch thread keeps ``depth`` batches ahead of the training loop.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher", "make_batch_iterator"]


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic LM stream (learnable: next = f(prev) + noise)."""

    vocab: int
    batch: int                    # per-host batch
    seq_len: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    frames_dim: Optional[int] = None   # encdec: also emit frames (B, S/4, D)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.batch, self.seq_len, self.vocab
        # learnable structure: token_{t+1} = (a * token_t + c) % v, with noise
        a, c = 31, 7
        t0 = rng.integers(0, v, size=(b, 1))
        toks = [t0]
        for _ in range(s):
            nxt = (a * toks[-1] + c) % v
            noise = rng.random((b, 1)) < 0.1
            rnd = rng.integers(0, v, size=(b, 1))
            toks.append(np.where(noise, rnd, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        out = {"tokens": seq[:, :s], "targets": seq[:, 1: s + 1]}
        if self.frames_dim is not None:
            out["frames"] = rng.standard_normal(
                (b, max(1, s // 4), self.frames_dim)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def make_batch_iterator(cfg, tcfg, *, host_id: int = 0, num_hosts: int = 1,
                        start_step: int = 0, prefetch: int = 2):
    """Sharded, prefetched iterator resuming at ``start_step``."""
    assert tcfg.global_batch % num_hosts == 0
    src = SyntheticLM(
        vocab=cfg.vocab,
        batch=tcfg.global_batch // num_hosts,
        seq_len=tcfg.seq_len,
        seed=tcfg.seed,
        host_id=host_id,
        num_hosts=num_hosts,
        frames_dim=cfg.d_model if cfg.frontend == "frames" else None,
    )

    def gen():
        step = start_step
        while True:
            yield src.batch_at(step)
            step += 1

    return Prefetcher(gen(), depth=prefetch)
