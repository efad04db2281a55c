"""Dynamic micro-batcher — drain, bucket, batch, dispatch.

The scheduler is the piece that turns ragged open-loop traffic into the
static shapes the accelerator takes.  One background thread drains the
admission queue and groups requests by `(bucket, policy)`:

  * bucket — the smallest configured static n_points shape that holds the
    cloud (larger clouds stride-subsample down to the largest bucket), via
    the same `pad_cloud` used by the synchronous serve path.  Each bucket is
    one static shape of the accelerator's forward, so a small bucket set
    caps the shapes to warm while keeping padding waste low (the PointAcc "versatile
    mapping" idea applied to shapes).
  * policy — the resolved ExecutionPolicy.  A batch never mixes policies,
    so fp32 and SC W16A16 traffic can interleave at the request level while
    each micro-batch still hits exactly one (config, policy) artifact.  The
    policy's `pipeline` knob participates in the key too: batches under a
    "pipelined" policy run the replica's two-stage overlapped schedule
    (dispatch.py) while "sequential" batches run the fused artifact, and
    the two kinds of traffic NEVER share a micro-batch or an artifact.

  * SLO class — the request's `SLOClass` (serve/slo.py) completes the key,
    so a micro-batch never mixes service classes: an interactive batch
    never waits on a bulk class's flush timer, and a class with
    `max_wait_s` set flushes its partial batches on its own tighter bound.

A key flushes when it holds `max_batch` requests or its oldest request has
waited `max_wait_s` (tightened per class by `SLOClass.max_wait_s`) — the
classic dynamic-batching latency/occupancy knob.  Keys flush in priority
order, so when higher- and lower-class batches are ready in the same drain
tick the higher class is dispatched (and starts executing) first.  Batch
assembly (`assemble_batch`) and result scatter (`scatter_results`)
are pure functions shared with the tests, which pin the scheduler's output
bitwise against a direct `accel.infer` on the same padded batch.

`max_inflight` bounds dispatched-but-unfinished batches.  This is what
makes the SLO policy REAL under overload: without it the drain loop shovels
the whole backlog into the replicas' FIFO executor queues, where priority,
EDF and shedding no longer apply (an interactive batch waits behind every
bulk batch dispatched before it).  With the bound, the scheduler only
drains what the replicas can actually absorb, the backlog stays in the
admission queue — drained priority-first, shed above the budget — and a
later high-class arrival overtakes every bulk request still queued.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pointcloud import inverse_subsample_indices, pad_cloud
from repro_torch.serve.queue import (
    AdmissionQueue,
    DeadlineExceeded,
    Request,
    try_set_exception,
    try_set_result,
)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Dynamic-batching knobs: batch size, flush latency, drain granularity.

    The config is VERSIONED and swapped atomically: the drain loop reads
    `scheduler.config` exactly once per tick into a local, so every batch
    of one tick is assembled under one consistent config — a live
    reconfiguration (`BatchScheduler.apply_config`) can never produce a
    batch that mixes the old `max_batch` shape with the new one.
    """

    max_batch: int = 8  # static batch dim of every micro-batch
    max_wait_s: float = 0.005  # flush a partial batch after this long
    drain_tick_s: float = 0.002  # scheduler wake-up granularity
    # dispatched-but-unfinished batch bound (None = unbounded).  Set it to a
    # small multiple of the replica count so overload backlog stays in the
    # admission queue (where priority/EDF/shedding act) instead of the
    # replicas' FIFO executor queues (where nothing does)
    max_inflight: int | None = None
    # monotonically increasing on every live reconfiguration; batches and
    # decision logs reference the version their knobs came from
    version: int = 0
    # per-class partial-flush wait overrides from the adaptive controller,
    # (class name, seconds) pairs — tighter of this and SLOClass.max_wait_s
    # wins; a hashable tuple so the config stays frozen/comparable
    class_max_wait: tuple[tuple[str, float], ...] = ()

    def wait_for_class(self, name: str) -> float | None:
        """The configured per-class wait override for `name`, or None."""
        for cls_name, wait_s in self.class_max_wait:
            if cls_name == name:
                return wait_s
        return None


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: lives in sets
class MicroBatch:
    """One schedulable unit: same bucket, same policy, static shape.

    When the runtime enables the preprocess cache, `cache` carries it and
    `cache_entries` holds one CacheEntry-or-None per request as PEEKED at
    assembly time (each hit's canonical row was substituted into `batch`,
    so a hit row IS the cloud its cached neighborhoods were computed from).
    The dispatch layer re-probes at execution time — an assembly-time miss
    whose cloud was inserted by an earlier batch upgrades to a hit there —
    then splices hits / inserts misses; a batch whose every request hit
    skips the preprocess stage entirely.
    """

    requests: tuple[Request, ...]
    bucket: int  # n_points of the batch
    policy: object  # resolved ExecutionPolicy
    batch: np.ndarray  # (max_batch, bucket, 3 + F) float32, filler rows zero
    cache: object | None = None  # PreprocessCache, None = caching disabled
    cache_entries: tuple = ()  # per-request CacheEntry | None (when cache is set)
    batch_id: int = -1  # trace span id (-1 = untraced, e.g. warmup batches)

    @property
    def n_real(self) -> int:
        """Real requests in the batch; rows beyond this are zero filler."""
        return len(self.requests)

    @property
    def n_hits(self) -> int:
        """Requests whose preprocess result came from the cache."""
        return sum(1 for e in self.cache_entries if e is not None)

    @property
    def all_hit(self) -> bool:
        """True when EVERY real request hit — preprocess can be skipped."""
        return (
            self.cache is not None
            and self.n_real > 0
            and len(self.cache_entries) == self.n_real
            and all(e is not None for e in self.cache_entries)
        )


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that holds an n-row cloud.

    Oversized clouds take the largest bucket (and stride-subsample down to
    it, like pad_cloud).
    """
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def assemble_batch(
    requests: Sequence[Request],
    bucket: int,
    width: int,
    max_batch: int,
    rows: Sequence[np.ndarray | None] | None = None,
) -> np.ndarray:
    """Pure batch assembly onto the static (max_batch, bucket, width) shape.

    Each request's cloud is fitted to `bucket` rows via pad_cloud; filler
    batch rows stay zero.  `rows` optionally supplies pre-fitted
    (bucket, width) rows per request — the runtime's admission-time fit,
    or a cache hit's CANONICAL row (substituting it is what makes hit
    responses bitwise-equal to recomputing the cached cloud); a None entry
    falls back to pad_cloud.  Shared with tests so scheduler batches are
    bitwise-reproducible outside the runtime.
    """
    batch = np.zeros((max_batch, bucket, width), np.float32)
    for i, req in enumerate(requests):
        row = rows[i] if rows is not None else None
        if row is None:
            row = pad_cloud(np.asarray(req.cloud, np.float32), bucket)[0]
        batch[i] = row
    return batch


def scatter_results(task: str, logits: np.ndarray, mb: MicroBatch) -> list[np.ndarray]:
    """Per-request outputs from batched logits.

    cls: row i of the logits.  seg: padding rows dropped; for subsampled
    (oversized) clouds every original row gets its nearest surviving row's
    scores via the exact inverse of subsample_indices.
    """
    out = []
    for i, req in enumerate(mb.requests):
        if task != "seg":
            out.append(np.asarray(logits[i]))
        elif req.n_orig <= mb.bucket:
            out.append(np.asarray(logits[i, : req.n_orig]))
        else:
            inv = inverse_subsample_indices(req.n_orig, mb.bucket)
            out.append(np.asarray(logits[i, inv]))
    return out


class BatchScheduler:
    """Background drain loop: queue -> MicroBatch -> dispatch_fn.

    dispatch_fn(mb) is the replica pool's submit; it returns a future whose
    result is the batched logits (np.ndarray).  The scheduler wires the
    per-request scatter + metrics into the future's done-callback, so result
    fan-out happens on the replica thread and the drain loop never blocks on
    execution (Mesorasi-style stage decoupling: admission, batching and
    compute overlap).
    """

    def __init__(
        self,
        queue: AdmissionQueue,
        dispatch_fn: Callable,
        *,
        task: str,
        width: int,
        buckets: Sequence[int],
        config: SchedulerConfig | None = None,
        metrics: ServeMetrics | None = None,
        cache=None,
        tracer=None,
    ):
        self.queue = queue
        self.dispatch_fn = dispatch_fn
        self.task = task
        self.width = width
        self.buckets = tuple(sorted(buckets))
        self.config = config or SchedulerConfig()
        self.metrics = metrics or ServeMetrics()
        self.cache = cache  # PreprocessCache | None — peeked at _dispatch
        self.tracer = tracer  # Tracer | None — None means tracing is off
        self._pending: dict[tuple, list[Request]] = {}
        self._inflight: set = set()
        self._inflight_cond = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="pc2im-scheduler", daemon=True
        )

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        """Start the background drain thread; returns self for chaining."""
        self._thread.start()
        return self

    def apply_config(self, config: SchedulerConfig) -> SchedulerConfig:
        """Atomically swap the scheduler config for the next drain tick.

        The drain loop reads `self.config` once per tick, so the swap is a
        single reference assignment: batches formed before the swap complete
        under the old config, batches formed after use the new one, and no
        batch ever mixes the two (the pause-free reconfiguration path —
        warm the new artifacts first, then call this).  Returns the applied
        config (its `version` is forced past the current one).
        """
        if config.version <= self.config.version:
            config = dataclasses.replace(config, version=self.config.version + 1)
        self.config = config
        return config

    def stop(self, drain: bool = True):
        """Stop the drain loop.

        drain=True flushes queued + pending requests and waits for their
        batches to complete first; drain=False cancels them.
        """
        self._stop.set()
        self._thread.join()
        leftovers = self.queue.close()
        if drain:
            self._admit(leftovers)
            self._flush_all()
            self._wait_inflight()
        else:
            for req in leftovers + [r for lst in self._pending.values() for r in lst]:
                req.future.cancel()
            self._pending.clear()

    def _wait_inflight(self, timeout_s: float = 60.0):
        deadline = time.monotonic() + timeout_s
        with self._inflight_cond:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cond.wait(remaining)

    # -- drain loop -----------------------------------------------------------

    def _budget(self, cfg: SchedulerConfig) -> int | None:
        """Batches the scheduler may still dispatch right now (None = ∞)."""
        if cfg.max_inflight is None:
            return None
        with self._inflight_cond:
            return cfg.max_inflight - len(self._inflight)

    def _run(self):
        while not self._stop.is_set():
            # ONE config read per tick: apply_config swaps the reference
            # atomically, so everything this iteration does — drain size,
            # flush thresholds, batch assembly shape — sees one consistent
            # config and never a half-applied reconfiguration
            cfg = self.config
            # the drain thread must survive anything a single bad request can
            # throw (it serves every OTHER request too) — _dispatch already
            # fails the affected batch; this is the last-resort guard
            try:
                budget = self._budget(cfg)
                if budget is not None and budget <= 0:
                    # replicas saturated: leave the backlog in the admission
                    # queue — draining it now would freeze its priority order
                    # into FIFO executor queues.  Wake when a batch finishes
                    with self._inflight_cond:
                        if len(self._inflight) >= cfg.max_inflight:
                            self._inflight_cond.wait(cfg.drain_tick_s)
                    continue
                reqs = self.queue.drain(cfg.max_batch, cfg.drain_tick_s)
                if reqs:
                    self.metrics.record_queue_depth(self.queue.depth() + len(reqs))
                self._admit(reqs)
                self._flush_ready(cfg)
            except Exception:  # noqa: BLE001
                self.metrics.record_failed()

    def _admit(self, reqs: Sequence[Request]):
        now = time.monotonic()
        for req in reqs:
            if self.tracer is not None and req.trace_id is not None:
                self.tracer.emit(
                    "request.drained", trace_id=req.trace_id, slo=req.slo.name, t=now
                )
            if req.future.done():  # client cancelled while queued
                continue
            if req.expired(now):
                self._expire(req)
                continue
            self._pending.setdefault(req.key, []).append(req)

    def _expire(self, req: Request):
        if try_set_exception(
            req.future, DeadlineExceeded(f"request {req.id} deadline passed")
        ):
            self.metrics.record_expired(req.slo.name)
            if self.tracer is not None and req.trace_id is not None:
                self.tracer.emit(
                    "request.expired", trace_id=req.trace_id, slo=req.slo.name
                )

    def _key_order(self, key: tuple) -> tuple:
        """Flush order of pending keys.

        Strict-priority mode: higher-priority classes first.  DRR mode
        (queue has class_weights): oldest drained request first — the
        weighted share is already encoded in the queue's drain order, and
        a priority sort here would hand every scarce dispatch slot back to
        the high class, re-starving the lanes DRR just protected.
        """
        if getattr(self.queue, "class_weights", None) is not None:
            lst = self._pending.get(key)
            return (min(r.id for r in lst) if lst else float("inf"),)
        return (-key[2].priority, key[2].name)

    def _max_wait(self, key: tuple, cfg: SchedulerConfig) -> float:
        """Partial-batch flush wait for one key — per-class bounds applied.

        The tightest of: the global `max_wait_s`, the class's own
        `SLOClass.max_wait_s`, and the adaptive controller's per-class
        override in `cfg.class_max_wait`.
        """
        wait = cfg.max_wait_s
        slo_wait = key[2].max_wait_s
        if slo_wait is not None:
            wait = min(wait, slo_wait)
        override = cfg.wait_for_class(key[2].name)
        if override is not None:
            wait = min(wait, override)
        return wait

    def _flush_ready(self, cfg: SchedulerConfig):
        now = time.monotonic()
        budget = self._budget(cfg)
        for key in sorted(self._pending, key=self._key_order):
            # priority-first AND budget-aware: when capacity is scarce the
            # highest class takes the remaining dispatch slots
            if budget is not None and budget <= 0:
                return
            lst = self._pending[key]
            while len(lst) >= cfg.max_batch and (budget is None or budget > 0):
                chunk, self._pending[key] = lst[: cfg.max_batch], lst[cfg.max_batch :]
                lst = self._pending[key]
                self._dispatch(key, chunk, cfg)
                if budget is not None:
                    budget -= 1
            if (
                lst
                and (budget is None or budget > 0)
                and now - lst[0].submit_t >= self._max_wait(key, cfg)
            ):
                self._pending[key] = []
                self._dispatch(key, lst, cfg)
                if budget is not None:
                    budget -= 1

    def _flush_all(self):
        # stop-time drain: the inflight bound is deliberately ignored — the
        # runtime is closing, the only goal is completing what was admitted
        cfg = self.config
        for key in sorted(self._pending, key=self._key_order):
            lst, self._pending[key] = self._pending[key], []
            for lo in range(0, len(lst), cfg.max_batch):
                self._dispatch(key, lst[lo : lo + cfg.max_batch], cfg)

    def _dispatch(self, key: tuple, requests: list[Request], cfg: SchedulerConfig | None = None):
        if cfg is None:
            cfg = self.config
        # shed what expired (or was cancelled) while waiting in _pending —
        # deadlines are re-checked at every stage, not just admission
        now = time.monotonic()
        live = []
        for req in requests:
            if req.expired(now):
                self._expire(req)
            elif not req.future.done():
                live.append(req)
        if not live:
            return
        bucket, policy, _slo = key
        # the preprocess cache does not compose with sharded policies (their
        # batches run the group's MeshArtifacts end to end; cached rows are
        # one device's trees): a sharded batch carries no cache at all, as in
        # the reference, so the dispatch layer's cache paths never see it
        cache = self.cache if getattr(policy, "sharding", None) is None else None
        try:
            entries: tuple = ()
            rows = None
            if cache is not None:
                # probe material is computed lazily HERE, on the scheduler
                # thread: admission stays O(1) for clients, and the fit +
                # hash overlap batch execution on the replica workers
                # instead of delaying either (tests may pre-compute keys;
                # those are kept as-is)
                for req in live:
                    if req.cache_key is None:
                        req.fitted = pad_cloud(
                            np.asarray(req.cloud, np.float32), bucket
                        )[0]
                        req.cache_key = cache.key_for(
                            bucket, policy, req.fitted
                        )
                # side-effect-free peek: a hit's canonical row replaces the
                # request's own fitted row in the batch, so the feature stage
                # consumes exactly the cloud the cached neighborhoods were
                # computed from.  The COUNTED lookup happens at execution
                # time (dispatch.py), where inserts from every earlier batch
                # on the replica are already visible — a peek-miss here can
                # still become a hit there.
                probe = [
                    cache.peek(req.cache_key)
                    if req.cache_key is not None
                    else None
                    for req in live
                ]
                entries = tuple(probe)
                if self.tracer is not None:
                    for req, ent in zip(live, entries):
                        if req.trace_id is not None:
                            self.tracer.emit(
                                "request.cache_peek",
                                trace_id=req.trace_id,
                                slo=req.slo.name,
                                args={"hit": ent is not None},
                            )
                rows = [
                    ent.row if ent is not None else req.fitted
                    for req, ent in zip(live, entries)
                ]
            batch = assemble_batch(
                live, bucket, self.width, cfg.max_batch, rows=rows
            )
        except Exception as e:  # noqa: BLE001 — one bad cloud fails ITS batch only
            self.metrics.record_failed(len(live))
            for req in live:
                won = try_set_exception(req.future, e)
                if won and self.tracer is not None and req.trace_id is not None:
                    self.tracer.emit(
                        "request.failed", trace_id=req.trace_id, slo=req.slo.name
                    )
            return
        mb = MicroBatch(
            requests=tuple(live),
            bucket=bucket,
            policy=policy,
            batch=batch,
            cache=cache,
            cache_entries=entries,
            batch_id=self.tracer.next_batch_id() if self.tracer is not None else -1,
        )
        if self.tracer is not None:
            self.tracer.emit(
                "batch.assembled",
                batch_id=mb.batch_id,
                slo=_slo.name,
                args={
                    "members": [r.trace_id for r in live if r.trace_id is not None],
                    "bucket": bucket,
                    "n_real": mb.n_real,
                    "n_hits": mb.n_hits,
                },
            )
            for req in live:
                if req.trace_id is not None:
                    self.tracer.emit(
                        "request.assembled",
                        trace_id=req.trace_id,
                        batch_id=mb.batch_id,
                        slo=req.slo.name,
                    )
        with self._inflight_cond:
            self._inflight.add(mb)
            n_inflight = len(self._inflight)
        self.metrics.record_inflight(n_inflight)
        fut = self.dispatch_fn(mb)
        fut.add_done_callback(lambda f, mb=mb: self._on_batch_done(mb, f))

    def _on_batch_done(self, mb: MicroBatch, fut):
        try:
            err = fut.exception()
            if err is not None:
                self.metrics.record_failed(mb.n_real)
                if self.tracer is not None and mb.batch_id != -1:
                    self.tracer.emit("batch.failed", batch_id=mb.batch_id)
                for req in mb.requests:
                    won = try_set_exception(req.future, err)
                    if won and self.tracer is not None and req.trace_id is not None:
                        self.tracer.emit(
                            "request.failed", trace_id=req.trace_id, slo=req.slo.name
                        )
                return
            outs = scatter_results(self.task, fut.result(), mb)
            now = time.monotonic()
            for req, out in zip(mb.requests, outs):
                if req.expired(now):
                    # executed but too late: an SLO client must NOT count a
                    # deadline-violating response as success
                    self._expire(req)
                elif try_set_result(req.future, out):
                    self.metrics.record_completed(now - req.submit_t, req.slo.name)
                    if self.tracer is not None and req.trace_id is not None:
                        # same `now` as the latency metric: the trace e2e and
                        # the recorded latency agree by construction
                        self.tracer.emit(
                            "request.completed",
                            trace_id=req.trace_id,
                            batch_id=mb.batch_id,
                            slo=req.slo.name,
                            t=now,
                        )
            if self.tracer is not None and mb.batch_id != -1:
                self.tracer.emit("batch.completed", batch_id=mb.batch_id)
        finally:
            with self._inflight_cond:
                self._inflight.discard(mb)
                self._inflight_cond.notify_all()
