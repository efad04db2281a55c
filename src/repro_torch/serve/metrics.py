"""Serving metrics — thread-safe counters + reservoirs, snapshotted on demand.

Every component of the serving runtime reports here: the admission queue
(rejections), the scheduler (queue depth at drain, batch occupancy, expired
deadlines), the replica pool (retries, evictions, stragglers) and the
result scatter (per-request latency).  `snapshot()` reduces the raw samples
to the numbers tests and benchmarks assert on — p50/p95/p99 latency,
throughput, mean occupancy — without ever blocking the hot path for more
than a lock-protected append.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

_RESERVOIR = 65536  # keep the newest N samples per series


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One executed micro-batch (who ran it, how full it was)."""

    bucket: int  # static n_points shape the batch was padded to
    policy_key: tuple  # (quant, backend, pipeline, sharding) of the batch's ExecutionPolicy
    n_real: int  # real requests in the batch (rest is filler)
    batch_size: int  # static batch dim
    replica_id: int
    duration_s: float
    preprocess_skipped: bool = False  # all-hit batch: entered the feature stage directly
    batch_id: int = -1  # trace span id of the micro-batch (-1 when tracing is off)


@dataclasses.dataclass(frozen=True)
class ClassSnapshot:
    """Per-SLO-class reduction inside one MetricsSnapshot.

    Counts and latency percentiles attributed to one class name — the
    load-shedding contract is asserted against these (a non-sheddable
    class must show shed == 0 while the sheddable class absorbs it all).
    """

    name: str
    submitted: int
    completed: int
    shed: int
    expired: int
    rejected: int
    latency_p50_s: float
    latency_p95_s: float
    depth_hwm: int = 0  # max depth this class's admission lane ever reached

    def format_row(self) -> str:
        """One-line human summary of this class (serve_slo prints these)."""
        return (
            f"[{self.name}] submitted={self.submitted} completed={self.completed} "
            f"shed={self.shed} expired={self.expired} rejected={self.rejected} "
            f"p50={self.latency_p50_s * 1e3:.1f}ms p95={self.latency_p95_s * 1e3:.1f}ms"
        )


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Immutable reduction of one runtime's metrics at a point in time.

    Counters (submitted..straggler_events) are totals since construction;
    latency percentiles, throughput and occupancy are computed over the
    retained reservoirs — exactly the numbers benchmarks and tests assert
    on (see snapshot() for the definitions).  `per_class` breaks the
    request counters and latency percentiles down by SLO class; the
    aggregate fields keep their pre-SLO definitions (shed requests are NOT
    counted as rejected — each outcome is exactly one counter).
    """

    submitted: int
    completed: int
    rejected: int
    expired: int
    failed: int
    retries: int
    evictions: int
    batches: int  # executed micro-batches that carried real traffic
    straggler_events: int
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float
    throughput_rps: float  # completed requests / observed serving window
    mean_occupancy: float  # mean(n_real / batch_size) over executed batches
    queue_depth_mean: float
    queue_depth_max: int
    cache_hits: int = 0  # preprocess-cache lookups that hit
    cache_misses: int = 0  # preprocess-cache lookups that missed
    preprocess_skipped: int = 0  # all-hit batches that skipped the preprocess stage
    cache_saved_s: float = 0.0  # estimated batch latency the skips avoided
    shed: int = 0  # requests load-shed (admission Shed + full-queue eviction)
    rejoins: int = 0  # replicas re-admitted to the pool (warm rejoin / scale-up)
    per_class: tuple[ClassSnapshot, ...] = ()  # per-SLO-class breakdown
    # true high-water marks, updated at every admission / dispatch (the
    # *_mean/_max fields above are point samples taken at scheduler drains
    # and miss bursts between drains)
    queue_depth_hwm: int = 0  # max total queued depth ever observed
    inflight_hwm: int = 0  # max concurrently-inflight micro-batches
    stragglers_by_replica: tuple[tuple[int, int], ...] = ()  # (replica_id, count)

    @property
    def cache_hit_rate(self) -> float:
        """hits / lookups of the preprocess cache, 0.0 with no lookups."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def for_class(self, name: str) -> ClassSnapshot | None:
        """The ClassSnapshot of one SLO class name, None if never seen."""
        for cs in self.per_class:
            if cs.name == name:
                return cs
        return None

    def format_class_rows(self) -> str:
        """Multi-line per-class summary (one ClassSnapshot.format_row each)."""
        return "\n".join(cs.format_row() for cs in self.per_class)

    def format_row(self) -> str:
        """One-line human summary (the serve benchmarks print this)."""
        row = (
            f"completed={self.completed} rejected={self.rejected} "
            f"expired={self.expired} thr={self.throughput_rps:.1f}/s "
            f"p50={self.latency_p50_s * 1e3:.1f}ms p95={self.latency_p95_s * 1e3:.1f}ms "
            f"p99={self.latency_p99_s * 1e3:.1f}ms occ={self.mean_occupancy:.2f}"
        )
        if self.cache_hits or self.cache_misses:
            row += (
                f" hit={self.cache_hit_rate:.2f}"
                f" skip={self.preprocess_skipped}"
                f" saved={self.cache_saved_s * 1e3:.1f}ms"
            )
        return row


class _ClassStats:
    """Mutable per-SLO-class tallies inside ServeMetrics (lock owned there)."""

    __slots__ = (
        "submitted",
        "completed",
        "shed",
        "expired",
        "rejected",
        "latencies",
        "depth_hwm",
    )

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self.rejected = 0
        self.latencies: list[float] = []
        self.depth_hwm = 0


class ServeMetrics:
    """Mutable, thread-safe metrics hub for one runtime instance.

    Request-outcome recorders take an optional SLO class name; aggregate
    counters always move, and the named class's breakdown moves with them
    (the per-class view in `snapshot().per_class`).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        self.failed = 0
        self.retries = 0
        self.evictions = 0
        self.rejoins = 0
        self.shed = 0
        self.straggler_events = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.queue_depth_hwm = 0
        self.inflight_hwm = 0
        self._straggler_by_replica: dict[int, int] = {}
        self._latencies: list[float] = []
        self._latency_ts: list[float] = []  # completion stamps, parallel to _latencies
        self._sizes: list[int] = []  # admitted request sizes (n_points)
        self._arrivals: list[float] = []  # admission stamps, parallel to _sizes
        self._arrival_names: list[str] = []  # SLO class names, parallel to _sizes
        self._depths: list[int] = []
        self._batches: list[BatchRecord] = []
        self._by_class: dict[str, _ClassStats] = {}
        self._first_t: float | None = None
        self._last_t: float | None = None

    def _cls(self, name: str | None) -> _ClassStats:
        """Per-class tally for `name` (call under the lock); None -> default."""
        return self._by_class.setdefault(name or "default", _ClassStats())

    # -- recording (one lock-protected append each) --------------------------

    def record_submitted(self, slo_name: str | None = None):
        """Count one admitted request (starts the observation window)."""
        with self._lock:
            self.submitted += 1
            self._cls(slo_name).submitted += 1
            if self._first_t is None:
                self._first_t = time.monotonic()

    def record_arrival(self, n_points: int, slo_name: str | None = None):
        """Record one admitted request's cloud size and arrival instant.

        The adaptive controller's raw material: `request_sizes()` feeds the
        bucket-boundary proposal, `arrival_times()` / `arrivals_by_class()`
        the inter-arrival and batching-patience estimates.  Reservoir-
        bounded like every series.
        """
        with self._lock:
            self._sizes.append(int(n_points))
            self._arrivals.append(time.monotonic())
            self._arrival_names.append(slo_name or "default")
            del self._sizes[:-_RESERVOIR]
            del self._arrivals[:-_RESERVOIR]
            del self._arrival_names[:-_RESERVOIR]

    def record_rejected(self, slo_name: str | None = None):
        """Count one request refused at admission (QueueFull/QueueClosed)."""
        with self._lock:
            self.rejected += 1
            self._cls(slo_name).rejected += 1

    def record_shed(self, slo_name: str | None = None):
        """Count one request load-shed (admission Shed or queued eviction)."""
        with self._lock:
            self.shed += 1
            self._cls(slo_name).shed += 1

    def record_expired(self, slo_name: str | None = None):
        """Count one request failed because its deadline passed."""
        with self._lock:
            self.expired += 1
            self._cls(slo_name).expired += 1

    def record_failed(self, n: int = 1):
        """Count n requests failed by execution errors (not deadlines)."""
        with self._lock:
            self.failed += n

    def record_retry(self):
        """Count one batch re-dispatch after a replica failure."""
        with self._lock:
            self.retries += 1

    def record_eviction(self):
        """Count one replica evicted by the heartbeat monitor."""
        with self._lock:
            self.evictions += 1

    def record_rejoin(self):
        """Count one replica re-admitted to the pool (warm rejoin/scale-up)."""
        with self._lock:
            self.rejoins += 1

    def record_straggler(self, event=None, replica_id: int | None = None):
        """Count one straggler event (slow-but-alive replica batch).

        `event` is the StragglerMonitor's StragglerEvent (duration/median/
        ratio); `replica_id` attributes it to the replica whose monitor
        fired, feeding the `stragglers_by_replica` snapshot breakdown.
        """
        del event  # durations flow to the trace stream (ReplicaPool hook)
        with self._lock:
            self.straggler_events += 1
            if replica_id is not None:
                self._straggler_by_replica[replica_id] = (
                    self._straggler_by_replica.get(replica_id, 0) + 1
                )

    def record_queue_hwm(self, depth: int, slo_name: str | None = None,
                         class_depth: int | None = None):
        """Raise the queue-depth high-water marks after one admission.

        Called by the admission queue with the post-append total depth and
        the admitted request's lane depth — unlike record_queue_depth this
        sees every enqueue, so bursts between scheduler drains register.
        """
        with self._lock:
            if depth > self.queue_depth_hwm:
                self.queue_depth_hwm = depth
            if class_depth is not None:
                cls = self._cls(slo_name)
                if class_depth > cls.depth_hwm:
                    cls.depth_hwm = class_depth

    def record_inflight(self, n: int):
        """Raise the inflight-micro-batch high-water mark after a dispatch."""
        with self._lock:
            if n > self.inflight_hwm:
                self.inflight_hwm = n

    def record_cache_lookup(self, hit: bool, n: int = 1):
        """Count n preprocess-cache probes resolved at batch execution."""
        with self._lock:
            if hit:
                self.cache_hits += n
            else:
                self.cache_misses += n

    def record_completed(self, latency_s: float, slo_name: str | None = None):
        """Record one completed request and its end-to-end latency."""
        with self._lock:
            self.completed += 1
            self._last_t = time.monotonic()
            self._latencies.append(latency_s)
            self._latency_ts.append(self._last_t)
            del self._latencies[:-_RESERVOIR]
            del self._latency_ts[:-_RESERVOIR]
            cls = self._cls(slo_name)
            cls.completed += 1
            cls.latencies.append(latency_s)
            del cls.latencies[:-_RESERVOIR]

    def record_queue_depth(self, depth: int):
        """Sample the admission-queue depth at a scheduler drain."""
        with self._lock:
            self._depths.append(depth)
            del self._depths[:-_RESERVOIR]

    def record_batch(self, record: BatchRecord):
        """Log one executed micro-batch (occupancy/duration source)."""
        with self._lock:
            self._batches.append(record)
            del self._batches[:-_RESERVOIR]

    # -- reading --------------------------------------------------------------

    def request_sizes(self) -> np.ndarray:
        """Retained admitted-request sizes (newest _RESERVOIR), int64 array."""
        with self._lock:
            return np.asarray(self._sizes, np.int64)

    def arrival_times(self) -> np.ndarray:
        """Retained admission instants (time.monotonic), float64 array."""
        with self._lock:
            return np.asarray(self._arrivals, np.float64)

    def arrivals_by_class(self) -> dict[str, np.ndarray]:
        """Admission instants split per SLO class name (per-class patience)."""
        with self._lock:
            out: dict[str, list[float]] = {}
            for t, name in zip(self._arrivals, self._arrival_names):
                out.setdefault(name, []).append(t)
            return {name: np.asarray(ts, np.float64) for name, ts in out.items()}

    def latencies_since(self, t: float) -> np.ndarray:
        """Latencies of requests completed at or after monotonic instant `t`.

        The rollback guard's window: percentiles over only the completions
        observed since a reconfiguration, so a swap's effect is judged
        against fresh evidence rather than the whole reservoir.
        """
        with self._lock:
            return np.asarray(
                [
                    lat
                    for lat, ts in zip(self._latencies, self._latency_ts)
                    if ts >= t
                ],
                np.float64,
            )

    @property
    def batch_records(self) -> tuple[BatchRecord, ...]:
        """The retained BatchRecord log (newest _RESERVOIR entries)."""
        with self._lock:
            return tuple(self._batches)

    def snapshot(self) -> MetricsSnapshot:
        """Reduce the raw samples to a MetricsSnapshot.

        Throughput is completed requests over the first-submit..last-complete
        window; occupancy averages n_real/batch_size over batches that
        carried real traffic (warmup batches are excluded).
        """
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            p50, p95, p99 = (
                (float(np.percentile(lat, q)) for q in (50, 95, 99))
                if lat.size
                else (0.0, 0.0, 0.0)
            )
            window = (
                (self._last_t - self._first_t)
                if self._first_t is not None and self._last_t is not None
                else 0.0
            )
            # warmup batches carry no requests (n_real=0); averaging them in
            # would understate the occupancy real traffic actually saw
            real = [b for b in self._batches if b.n_real]
            occ = (
                float(np.mean([b.n_real / b.batch_size for b in real]))
                if real
                else 0.0
            )
            # saved-latency estimate: what an all-hit batch costs vs what the
            # same traffic costs through the full preprocess+feature path.
            # An estimate, not a measurement — the avoided work never ran
            skipped = [b.duration_s for b in real if b.preprocess_skipped]
            full = [b.duration_s for b in real if not b.preprocess_skipped]
            saved = (
                len(skipped) * max(0.0, float(np.mean(full)) - float(np.mean(skipped)))
                if skipped and full
                else 0.0
            )
            depths = np.asarray(self._depths, np.int64)
            per_class = []
            for name in sorted(self._by_class):
                cls = self._by_class[name]
                clat = np.asarray(cls.latencies, np.float64)
                cp50, cp95 = (
                    (float(np.percentile(clat, q)) for q in (50, 95))
                    if clat.size
                    else (0.0, 0.0)
                )
                per_class.append(ClassSnapshot(
                    name=name,
                    submitted=cls.submitted,
                    completed=cls.completed,
                    shed=cls.shed,
                    expired=cls.expired,
                    rejected=cls.rejected,
                    latency_p50_s=cp50,
                    latency_p95_s=cp95,
                    depth_hwm=cls.depth_hwm,
                ))
            return MetricsSnapshot(
                submitted=self.submitted,
                completed=self.completed,
                rejected=self.rejected,
                expired=self.expired,
                failed=self.failed,
                retries=self.retries,
                evictions=self.evictions,
                batches=len(real),
                straggler_events=self.straggler_events,
                latency_p50_s=p50,
                latency_p95_s=p95,
                latency_p99_s=p99,
                throughput_rps=(self.completed / window) if window > 0 else 0.0,
                mean_occupancy=occ,
                queue_depth_mean=float(depths.mean()) if depths.size else 0.0,
                queue_depth_max=int(depths.max()) if depths.size else 0,
                cache_hits=self.cache_hits,
                cache_misses=self.cache_misses,
                preprocess_skipped=len(skipped),
                cache_saved_s=saved,
                shed=self.shed,
                rejoins=self.rejoins,
                per_class=tuple(per_class),
                queue_depth_hwm=self.queue_depth_hwm,
                inflight_hwm=self.inflight_hwm,
                stragglers_by_replica=tuple(
                    sorted(self._straggler_by_replica.items())
                ),
            )
