"""Persistent on-disk autotune/measurement database (fleet-shared).

A copy of ``repro.tune.db`` (stdlib only), with one port-side addition:
:func:`db_key` takes the mesh *placement*
(:func:`repro_torch.launch.mesh.mesh_placement`), as autotune's in-memory
key does, and autotune passes the card's kind as ``accel`` when it
measured on one.  A key without a placement is byte-equal to the JAX
package's for the same arguments.

``AutotunePolicy`` measures every candidate dataflow on-device the first
time it sees a pattern — expensive, and until now the result lived in one
process's in-memory dict, so every server in a fleet (and every restart)
re-paid the sweep.  :class:`TuneDB` makes the measurement cache durable
and shared:

- **append-only JSONL** — each measurement is one self-describing line;
  writers only ever append, so concurrent processes cannot corrupt each
  other's records.  Partial/garbled lines (a writer died mid-append) are
  skipped on read.  Last record per key wins.
- **file-lock-safe** — appends and compactions take an exclusive
  ``fcntl`` lock on a sidecar ``.lock`` file (no-op on platforms without
  ``fcntl``); reads are lock-free tail reads from the last seen offset.
- **read-through** — a ``get`` miss re-reads the file tail before giving
  up, so a record another process appended after this one opened the DB
  is still found (the cross-process cold-start-hit contract asserted in
  ``tests/test_torch_tune.py``).
- **compaction** — :meth:`compact` rewrites the file keeping only the
  newest record per key (bounded by ``compact_above``: ``put`` compacts
  automatically once the file holds that many lines).

Keys (:func:`db_key`) are deterministic across interpreters and hosts:
pattern fingerprint × backend name × block shape × memory budget ×
mesh/partition (× placement) × :func:`accelerator_hash` (or the card's
kind) — everything that changes what a measurement means.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

__all__ = ["TuneDB", "db_key", "accelerator_hash"]

try:                                    # POSIX file locks; absent on some
    import fcntl                        # platforms — locking degrades to
except ImportError:                     # best-effort (appends stay atomic
    fcntl = None                        # for line-sized writes anyway)


def accelerator_hash(cfg: Any) -> str:
    """Deterministic short hash of an ``AcceleratorConfig`` (or ``None``).

    Part of every DB key: a measurement taken against one accelerator
    configuration must never answer for another.  Hashes the sorted field
    dict, so it is stable across interpreters, field order, and hosts.
    """
    if cfg is None:
        return "-"
    if dataclasses.is_dataclass(cfg):
        items = sorted(dataclasses.asdict(cfg).items())
    elif isinstance(cfg, dict):
        items = sorted(cfg.items())
    else:
        items = [("repr", repr(cfg))]
    payload = json.dumps(items, sort_keys=True, default=repr)
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def _budget_key(budget: Any) -> Optional[Tuple[int, int, int]]:
    if budget is None:
        return None
    return (int(budget.l1_bytes), int(budget.l2_bytes),
            int(budget.dtype_bytes))


def _partition_key(partition: Any) -> Optional[Tuple]:
    if partition is None:
        return None
    return (getattr(partition, "axis", None),
            getattr(partition, "shards", None))


def db_key(fingerprint: str, backend_name: str,
           block_shape: Tuple[int, int, int],
           memory_budget: Any = None, mesh_key: Any = None,
           partition: Any = None, accel: Any = None,
           placement: Any = None) -> str:
    """The measurement's durable identity (see module docstring).

    Stable across interpreters: built from a canonical repr of plain
    tuples/ints/strings only (property-tested cross-process in
    ``tests/test_torch_tune.py``).  ``accel`` is an accelerator config
    (hashed) or a string taken as it is, such as a card's kind;
    ``placement`` (a mesh placement tuple) is appended only when given.
    """
    parts = (str(fingerprint), str(backend_name),
             tuple(int(b) for b in block_shape),
             _budget_key(memory_budget),
             tuple(mesh_key) if mesh_key is not None else None,
             _partition_key(partition),
             accel if isinstance(accel, str) else accelerator_hash(accel))
    if placement is not None:
        parts += (tuple(placement),)
    return hashlib.sha1(repr(parts).encode()).hexdigest()


class _FileLock:
    """Exclusive advisory lock on ``<path>.lock`` (no-op without fcntl)."""

    def __init__(self, path: str):
        self._path = path + ".lock"
        self._fh = None

    def __enter__(self):
        if fcntl is not None:
            self._fh = open(self._path, "a+")
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        if self._fh is not None:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None
        return False


class TuneDB:
    """Append-only JSONL measurement store, shared across processes.

    ``get``/``put`` are a string-keyed dict surface over the durable file;
    ``hits``/``misses``/``appends`` counters feed telemetry
    (``AutotunePolicy.stats`` → ``ServeEngine.stats["policy"]``).
    """

    def __init__(self, path: str, compact_above: int = 4096):
        self.path = str(path)
        self.compact_above = compact_above
        self._records: Dict[str, dict] = {}
        self._offset = 0            # bytes of the file already absorbed
        self._lines = 0             # lines absorbed (compaction trigger)
        self.hits = 0
        self.misses = 0
        self.appends = 0
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._refresh()

    # -- durable I/O ------------------------------------------------------
    def _refresh(self) -> None:
        """Absorb lines appended (by anyone) since the last read."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size < self._offset:        # compacted/truncated underneath us
            self._records.clear()
            self._offset = 0
            self._lines = 0
        if size == self._offset:
            return
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read()
        # only absorb complete lines; a writer may be mid-append
        end = chunk.rfind(b"\n") + 1
        if end <= 0:
            return
        for line in chunk[:end].splitlines():
            self._lines += 1
            try:
                rec = json.loads(line)
                self._records[rec["key"]] = rec
            except (ValueError, KeyError, TypeError):
                continue               # torn/garbled line: skip, don't die
        self._offset += end

    def get(self, key: str) -> Optional[dict]:
        rec = self._records.get(key)
        if rec is None:
            self._refresh()            # read-through: another process may
            rec = self._records.get(key)   # have measured this by now
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def put(self, key: str, record: dict) -> None:
        rec = dict(record)
        rec["key"] = key
        line = json.dumps(rec, sort_keys=True, default=repr)
        with _FileLock(self.path):
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        self._records[key] = rec
        self.appends += 1
        self._refresh()
        if self.compact_above and self._lines > self.compact_above \
                and self._lines > 2 * len(self._records):
            self.compact()

    def compact(self) -> int:
        """Rewrite the file with one (newest) record per key.

        Returns the number of lines dropped.  Lock-exclusive: concurrent
        appends wait; concurrent readers detect the truncation via the
        shrunken size and re-read from scratch.
        """
        with _FileLock(self.path):
            # re-read everything under the lock so no concurrent append
            # between our last refresh and the rewrite is lost
            self._records.clear()
            self._offset = 0
            self._lines = 0
            self._refresh()
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for rec in self._records.values():
                    f.write(json.dumps(rec, sort_keys=True, default=repr)
                            + "\n")
                f.flush()
                os.fsync(f.fileno())
            dropped = self._lines - len(self._records)
            os.replace(tmp, self.path)
            self._offset = os.path.getsize(self.path)
            self._lines = len(self._records)
        return dropped

    # -- dict-ish views ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, key: str) -> bool:
        return self._records.get(key) is not None or self.get(key) is not None

    def keys(self) -> Iterator[str]:
        return iter(self._records)

    @property
    def stats(self) -> Dict[str, Any]:
        return {"path": self.path, "entries": len(self._records),
                "hits": self.hits, "misses": self.misses,
                "appends": self.appends}
