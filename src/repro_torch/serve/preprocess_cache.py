"""Cross-request preprocess cache — content-addressed neighborhood reuse.

PC2IM's thesis is eliminating *repetitive* work in point-cloud
preprocessing: APD-CIM kills redundant distance reads, the Ping-Pong-MAX CAM
keeps temporary distances in-situ.  This module is the serving-level analog.
Identical and near-identical clouds — static scenes, consecutive lidar
sweeps — used to recompute FPS/kNN/partition from scratch on every request;
here, the first computation of a cloud's neighborhoods is stored under a
content address (serve/hashing.py: a quantized-coordinate hash, tolerant of
float noise below the quantization step, so repeat sweeps of a static scene
collide on purpose) and every later request with the same address skips the
preprocess stage entirely and enters the feature stage directly.

What an entry stores, and why a hit is exact:

  * `row` — the CANONICAL fitted cloud: the (bucket, 3+F) batch row the
    first request was padded to.  On a hit the scheduler substitutes this
    row into the micro-batch, so the feature stage consumes exactly the
    cloud the cached neighborhoods were computed from and the hit response
    is bitwise-equal to an uncached recomputation of that canonical cloud.
    (For exact duplicates — same padded bytes — that IS the request's own
    recomputation; for sub-step-noise near-duplicates it is the static
    scene's response, which is the documented tolerance.)
  * `pre` — the per-row preprocess payload: one host PreprocessResult per
    SA stage (`core.engine.result_row` of the batched
    `accel.preprocess_stage` output), re-stacked per micro-batch by the
    dispatch layer.

The cache is a byte-budgeted LRU: insertions account every array byte of
the payload plus the canonical row (`core.engine.result_nbytes`), and the
least-recently-hit entries are evicted until the budget holds.  Entries are
keyed by `(bucket, resolved ExecutionPolicy, content digest)` — the FULL
policy, so results cached under one (quant, backend, pipeline) artifact are
never served to a different policy (see tests/test_serve_runtime.py).
Everything is thread-safe: the scheduler probes, replica workers insert.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.core.engine import result_map, result_nbytes, result_to_host
from repro_torch.serve.hashing import DEFAULT_QUANT_STEP, content_key


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs of the preprocess cache.

    max_bytes bounds resident payload bytes (canonical rows included);
    quant_step is the content-hash lattice pitch — noise below half a step
    around a lattice cell keys identically (serve/hashing.py documents the
    full invariance contract).
    """

    max_bytes: int = 64 * 2**20
    quant_step: float = DEFAULT_QUANT_STEP


@dataclasses.dataclass(frozen=True)
class PreprocessCacheStats:
    """Snapshot of one PreprocessCache (see `PreprocessCache.stats`).

    hits/misses count lookups; insertions/evictions/oversize count entry
    turnover (oversize = payloads larger than the whole budget, refused);
    entries/bytes describe what is resident right now.
    """

    hits: int
    misses: int
    insertions: int
    evictions: int
    oversize: int
    entries: int
    bytes: int
    max_bytes: int

    @property
    def hit_rate(self) -> float:
        """hits / lookups, 0.0 before any lookup happened."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CacheEntry:
    """One cached cloud: canonical fitted row + per-row preprocess payload.

    Immutable after construction (arrays are read-only copies), so entries
    can be handed to replica threads without copying or locking; `nbytes`
    is the exact retained size the LRU budget accounts.
    """

    __slots__ = ("key", "row", "pre", "nbytes", "hits")

    def __init__(self, key: tuple, row: np.ndarray, pre):
        self.key = key
        self.row = np.array(row, copy=True)
        self.row.setflags(write=False)
        self.pre = _freeze(pre)
        self.nbytes = result_nbytes(self.pre) + self.row.nbytes
        self.hits = 0


def _freeze(tree):
    """Deep-copy a result tree to read-only numpy (detach from batch buffers).

    Cached payloads must not alias the batched preprocess output they were
    sliced from: the splice path mutates those buffers row-wise, and views
    would both see the mutation and pin the whole batch alive.
    """

    def one(arr):
        arr.setflags(write=False)
        return arr

    return result_map(one, result_to_host(tree))  # copies every leaf


class PreprocessCache:
    """Byte-budgeted, thread-safe LRU over content-addressed preprocess results.

    The serving runtime owns one instance per model config; the scheduler
    calls `key_for` + `peek` while assembling micro-batches, the replica
    pool re-`lookup`s at execution time (catching entries inserted after
    assembly) and calls `insert` after a miss batch finishes its preprocess
    stage.  `evict`/`clear` give operators explicit control; `stats()` is
    the introspection surface benchmarks and tests assert on.
    """

    def __init__(self, config: CacheConfig | None = None, *, tracer=None):
        self.config = config or CacheConfig()
        if self.config.max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {self.config.max_bytes}")
        self.tracer = tracer  # Tracer | None — insert/evict churn events
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._insertions = 0
        self._evictions = 0
        self._oversize = 0

    # -- addressing -----------------------------------------------------------

    def key_for(self, bucket: int, policy, row: np.ndarray) -> tuple:
        """Content address of one fitted batch row under one execution policy.

        Pure (no counters, no LRU effect): safe to call on the client thread
        at admission so the hash cost never serializes in the scheduler's
        drain loop.  `policy` must be the RESOLVED ExecutionPolicy — the full
        policy keys the entry, so no cached result can cross policies.
        """
        return (bucket, policy, content_key(row, self.config.quant_step))

    # -- lookup / insert ------------------------------------------------------

    def lookup(self, key: tuple) -> CacheEntry | None:
        """Hit test one key: returns the entry (refreshing LRU) or None.

        Counts exactly one hit or miss — call once per request per
        execution; use `peek` for speculative probes.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            entry.hits += 1
            return entry

    def peek(self, key: tuple) -> CacheEntry | None:
        """Read one entry with NO side effects (no counters, no LRU refresh).

        The scheduler peeks at assembly time to substitute a hit's canonical
        row into the batch; the dispatch layer's execution-time `lookup` is
        the authoritative, counted probe (it runs after every earlier batch
        on the replica has inserted, so it sees strictly more entries).
        """
        with self._lock:
            return self._entries.get(key)

    def insert(self, key: tuple, row: np.ndarray, pre) -> CacheEntry | None:
        """Store one cloud's preprocess payload under its content address.

        `row` is the fitted batch row the payload was computed from (becomes
        the canonical row substituted on later hits); `pre` is the per-row
        result tree (`core.engine.result_row` of the batched stage output).
        Inserting an existing key replaces the entry (refreshing it); a
        payload larger than the whole budget is refused (counted, returns
        None).  Evicts least-recently-hit entries until the budget holds.
        """
        entry = CacheEntry(key, row, pre)
        n_evicted = 0
        with self._lock:
            if entry.nbytes > self.config.max_bytes:
                self._oversize += 1
                return None
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self._insertions += 1
            while self._bytes > self.config.max_bytes:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
                self._evictions += 1
                n_evicted += 1
            resident = self._bytes
        # emit outside the cache lock: the tracer has its own
        if self.tracer is not None:
            self.tracer.emit(
                "cache.insert",
                args={"nbytes": entry.nbytes, "resident": resident},
            )
            if n_evicted:
                self.tracer.emit(
                    "cache.evict",
                    args={"n": n_evicted, "reason": "budget"},
                )
        return entry

    def top_entries(self, k: int) -> list[CacheEntry]:
        """The k hottest resident entries (most hits, then most recent).

        The replica pool pre-stages these on a rejoining replica's device
        (`Replica.stage_entry`) so its first all-hit batches skip the host
        restack.  No counters move and LRU order is untouched — this is an
        introspection read, not a use.
        """
        with self._lock:
            ranked = sorted(
                enumerate(self._entries.values()),
                key=lambda ie: (-ie[1].hits, -ie[0]),  # hits desc, then MRU
            )
            return [e for _, e in ranked[: max(0, k)]]

    # -- management -----------------------------------------------------------

    def evict(self, key: tuple) -> bool:
        """Explicitly drop one entry; True if it was resident."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
                self._evictions += 1
        if entry is not None and self.tracer is not None:
            self.tracer.emit("cache.evict", args={"n": 1, "reason": "explicit"})
        return entry is not None

    def clear(self) -> None:
        """Drop every entry (counters keep their history)."""
        with self._lock:
            self._evictions += len(self._entries)
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> PreprocessCacheStats:
        """Counters + residency in one immutable snapshot."""
        with self._lock:
            return PreprocessCacheStats(
                hits=self._hits,
                misses=self._misses,
                insertions=self._insertions,
                evictions=self._evictions,
                oversize=self._oversize,
                entries=len(self._entries),
                bytes=self._bytes,
                max_bytes=self.config.max_bytes,
            )

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        s = self.stats()
        return (
            f"PreprocessCache(entries={s.entries}, bytes={s.bytes}/{s.max_bytes}, "
            f"hit_rate={s.hit_rate:.2f})"
        )
