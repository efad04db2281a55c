"""Bounded admission queue — per-class lanes, deadlines, backpressure, shedding.

The front door of the serving runtime.  Every client request becomes a
`Request` with its own `concurrent.futures.Future`; admission is bounded so
a traffic spike turns into an explicit, reasoned rejection
(`AdmissionError.reason`) instead of unbounded memory growth and collapsing
tail latency.  Deadlines are absolute `time.monotonic()` instants carried on
the request; the scheduler fails expired requests with `DeadlineExceeded`
the moment it sees them, so a queue that fell behind sheds exactly the work
whose answer nobody is still waiting for.

Requests carry an `SLOClass` (serve/slo.py) and wait in one lane per class.
`drain` releases requests in priority order, earliest-deadline-first within
a priority — so under backlog the interactive lane empties before the bulk
lane is touched.  Passing `class_weights` switches the drain to deficit
round robin (DRR) across the lanes: each backlogged class receives service
proportional to its weight (EDF order preserved within a class), so a
saturated high class can no longer starve lower ones completely — the
weighted-fair alternative to the strict-priority default.  Load shedding is
two-stage and always explicit:

  * over the shed budget (`shed_threshold`) a sheddable admission is
    rejected with `Shed` at the front door, and
  * a completely full queue admits non-sheddable (or higher-priority)
    traffic by evicting the newest queued request of the lowest sheddable
    class — its future fails with `Shed`, never a silent drop.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable

import numpy as np

from repro_torch.core.policy import ExecutionPolicy
from repro_torch.serve.slo import DEFAULT, SLOClass, drain_key
from repro_torch.serve.trace import Tracer


def try_set_result(future: Future, result) -> bool:
    """Cancel-safe, exactly-one-winner future completion.

    A client may cancel() a queued future at any moment, and eviction
    re-dispatch can race a slow-but-alive replica to the same future —
    set_result must never raise into (and kill) a scheduler or replica
    thread, and the returned bool arbitrates which completion 'won' (only
    the winner records metrics)."""
    try:
        future.set_result(result)
        return True
    except InvalidStateError:  # cancelled, or the other completion won
        return False


def try_set_exception(future: Future, err: Exception) -> bool:
    """Fail a future if still open; see try_set_result for the race rules."""
    try:
        future.set_exception(err)
        return True
    except InvalidStateError:
        return False


class AdmissionError(RuntimeError):
    """Request rejected at the front door; `.reason` says why."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"request rejected ({reason})" + (f": {detail}" if detail else ""))


class QueueFull(AdmissionError):
    """Admission bound hit — explicit backpressure, never a silent drop."""

    def __init__(self, depth: int, max_depth: int):
        super().__init__("queue_full", f"depth {depth} >= max_depth {max_depth}")
        self.depth = depth
        self.max_depth = max_depth


class QueueClosed(AdmissionError):
    """The runtime stopped accepting traffic (stop() closed the queue)."""

    def __init__(self):
        super().__init__("closed", "runtime is stopped")


class Shed(AdmissionError):
    """Load shed — a sheddable request gave way to higher-priority traffic.

    Raised at admission when the backlog exceeds the shed budget, or set on
    a queued sheddable request's future when a full queue must admit
    non-sheddable traffic.  Distinct from QueueFull so clients (and
    per-class metrics) can tell deliberate shedding from plain overflow.
    """

    def __init__(self, slo_name: str, detail: str = ""):
        super().__init__("shed", detail or f"class {slo_name!r} shed under backlog")
        self.slo_name = slo_name


class DeadlineExceeded(TimeoutError):
    """Set on a request's future when its deadline passed before execution."""


@dataclasses.dataclass
class Request:
    """One admitted inference request.

    bucket is the static n_points shape the scheduler chose for this cloud;
    together with the resolved policy it forms the micro-batching key, so a
    batch never mixes shapes or execution policies (each key maps to exactly
    one accelerator).
    """

    id: int
    cloud: np.ndarray  # (n, 3 + F) float32
    n_orig: int  # original row count (pre pad/subsample)
    bucket: int  # static n_points shape this request is padded to
    policy: ExecutionPolicy  # RESOLVED policy (hashable batch key)
    deadline_t: float | None  # absolute time.monotonic() instant, None = no deadline
    submit_t: float
    future: Future
    # preprocess-cache probe: the bucket-fitted batch row and its content
    # address.  Computed lazily by the scheduler at assembly when caching is
    # enabled (admission stays O(1) on the client thread); tests may fill
    # them in ahead of time.  Stay None when caching is off — assembly then
    # falls back to pad_cloud and never touches the cache.
    fitted: np.ndarray | None = None  # (bucket, 3 + F) pad_cloud row
    cache_key: tuple | None = None  # PreprocessCache.key_for address
    slo: SLOClass = DEFAULT  # service class: priority, deadline, shed policy
    trace_id: int | None = None  # span id from Tracer.new_trace; None = untraced

    @property
    def key(self) -> tuple:
        """Micro-batching key — requests batch together iff keys match.

        The SLO class participates: a micro-batch never mixes classes, so
        a latency-bound class never waits on another class's flush timer
        and per-batch accounting stays attributable.
        """
        return (self.bucket, self.policy, self.slo)

    def expired(self, now: float | None = None) -> bool:
        """Whether the deadline passed (checked at every scheduling stage)."""
        if self.deadline_t is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline_t


class AdmissionQueue:
    """Bounded admission with per-SLO-class lanes and priority/EDF drain.

    One deque per SLOClass; `drain` releases requests by `slo.drain_key`
    (priority descending, earliest deadline first within a priority, then
    admission order), so the single-class default degenerates to the FIFO
    the pre-SLO runtime had.  `class_weights` (class name -> weight > 0)
    switches the drain to deficit round robin: lanes are visited in round-
    robin order, each visit grants the lane `weight` credits and one credit
    releases one request (EDF-first within the lane), with the unspent
    deficit carried to the lane's next turn — so over a sustained backlog
    each class's drained share converges to its weight fraction and no
    backlogged class starves.  Classes absent from the mapping drain with
    weight 1.0.  `shed_threshold` is the load-shedding budget:
    above it sheddable admissions raise `Shed`; a completely full queue
    evicts queued sheddable work to admit strictly-higher-priority traffic
    (each victim's future fails with `Shed` and `on_shed` is told).
    """

    def __init__(
        self,
        max_depth: int,
        *,
        shed_threshold: int | None = None,
        on_shed: Callable[[Request], None] | None = None,
        metrics=None,
        tracer: Tracer | None = None,
        class_weights: dict[str, float] | None = None,
    ):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if shed_threshold is not None and not (1 <= shed_threshold <= max_depth):
            raise ValueError(
                f"shed_threshold must be in [1, max_depth], got {shed_threshold}"
            )
        if class_weights is not None:
            for name, w in class_weights.items():
                if not (w > 0):
                    raise ValueError(
                        f"class_weights[{name!r}] must be > 0, got {w}"
                    )
        self.max_depth = max_depth
        self.shed_threshold = shed_threshold
        self.on_shed = on_shed
        self.metrics = metrics  # optional ServeMetrics: depth high-water marks
        self.tracer = tracer
        self.class_weights = dict(class_weights) if class_weights else None
        self._lanes: dict[SLOClass, collections.deque[Request]] = {}
        self._depth = 0
        self._cond = threading.Condition()
        self._closed = False
        self._ids = itertools.count()
        # DRR state (only used when class_weights is set): round-robin lane
        # order, per-lane unspent credits, and whether the head lane's turn
        # already received its quantum (a turn interrupted by max_items
        # resumes with its remaining deficit instead of double-granting)
        self._rr: collections.deque[SLOClass] = collections.deque()
        self._deficits: dict[SLOClass, float] = {}
        self._turn_granted = False

    def _shed_victim(self, priority: int) -> Request | None:
        """Pop the newest request of the lowest sheddable class below `priority`.

        Called under the lock by the full-queue admission path.  The newest
        request of the victim lane gives way (it would have been served
        last within its class), preserving FIFO fairness for the survivors.
        Returns None when nothing strictly lower-priority is sheddable —
        the incoming request then takes the plain QueueFull rejection.
        """
        victim_lane = None
        victim_prio = priority
        for slo, lane in self._lanes.items():
            if lane and slo.sheddable and slo.priority < victim_prio:
                victim_lane, victim_prio = lane, slo.priority
        if victim_lane is None:
            return None
        self._depth -= 1
        return victim_lane.pop()

    def submit(
        self,
        cloud: np.ndarray,
        *,
        bucket: int,
        policy: ExecutionPolicy,
        timeout_s: float | None = None,
        fitted: np.ndarray | None = None,
        cache_key: tuple | None = None,
        slo: SLOClass | None = None,
        trace_id: int | None = None,
    ) -> Future:
        """Admit one cloud; returns its future or raises AdmissionError.

        Backpressure is synchronous and explicit: over the shed budget a
        sheddable class is rejected with `Shed`; a full queue either evicts
        a queued lower-priority sheddable request (full lanes, see
        `_shed_victim`) or rejects with `QueueFull` — never a silent drop,
        so open-loop clients observe exactly the load that was shed.
        `fitted`/`cache_key` carry the preprocess-cache probe when the
        runtime computed one (see Request).
        """
        slo = slo if slo is not None else DEFAULT
        now = time.monotonic()
        if timeout_s is None:
            timeout_s = slo.deadline_s
        req = Request(
            id=-1,
            cloud=cloud,
            n_orig=cloud.shape[0],
            bucket=bucket,
            policy=policy,
            deadline_t=(now + timeout_s) if timeout_s is not None else None,
            submit_t=now,
            future=Future(),
            fitted=fitted,
            cache_key=cache_key,
            slo=slo,
            trace_id=trace_id,
        )
        victim = None
        with self._cond:
            if self._closed:
                raise QueueClosed()
            if (
                self.shed_threshold is not None
                and slo.sheddable
                and self._depth >= self.shed_threshold
            ):
                raise Shed(
                    slo.name,
                    f"class {slo.name!r}: depth {self._depth} >= "
                    f"shed budget {self.shed_threshold}",
                )
            if self._depth >= self.max_depth:
                victim = self._shed_victim(slo.priority)
                if victim is None:
                    raise QueueFull(self._depth, self.max_depth)
            req.id = next(self._ids)
            lane = self._lanes.setdefault(slo, collections.deque())
            lane.append(req)
            if self.class_weights is not None and slo not in self._rr:
                self._rr.append(slo)
            self._depth += 1
            depth_after, lane_after = self._depth, len(lane)
            self._cond.notify()
        # outside the lock: metrics/tracer take their own locks, and future
        # callbacks (and on_shed) may re-enter the queue
        if self.metrics is not None:
            self.metrics.record_queue_hwm(depth_after, slo.name, lane_after)
        if self.tracer is not None and req.trace_id is not None:
            self.tracer.emit("request.admitted", trace_id=req.trace_id, slo=slo.name)
            self.tracer.emit(
                "request.enqueued",
                trace_id=req.trace_id,
                slo=slo.name,
                args={"lane_depth": lane_after, "depth": depth_after},
            )
        if victim is not None:
            won = try_set_exception(
                victim.future,
                Shed(victim.slo.name, f"request {victim.id} evicted for "
                                      f"priority-{req.slo.priority} admission"),
            )
            if won and self.tracer is not None and victim.trace_id is not None:
                self.tracer.emit(
                    "request.shed",
                    trace_id=victim.trace_id,
                    slo=victim.slo.name,
                    args={"reason": "evicted"},
                )
            if self.on_shed is not None:
                self.on_shed(victim)
        return req.future

    def _pop_next(self) -> Request | None:
        """Pop the drain-order winner across every lane (under the lock)."""
        best = None
        best_key = None
        for slo, lane in self._lanes.items():
            for req in lane:
                key = drain_key(slo.priority, req.deadline_t, req.id)
                if best_key is None or key < best_key:
                    best, best_key = req, key
        if best is None:
            return None
        self._lanes[best.slo].remove(best)
        self._depth -= 1
        return best

    def _weight(self, slo: SLOClass) -> float:
        """DRR weight of one class; classes not configured weigh 1.0."""
        return self.class_weights.get(slo.name, 1.0)

    def _pop_edf(self, lane: collections.deque[Request]) -> Request:
        """Pop the earliest-deadline (then oldest) request of one lane."""
        best = min(
            lane,
            key=lambda r: (
                math.inf if r.deadline_t is None else r.deadline_t,
                r.id,
            ),
        )
        lane.remove(best)
        self._depth -= 1
        return best

    def _drain_drr(self, max_items: int) -> list[Request]:
        """Deficit-round-robin drain of up to max_items (under the lock).

        Each lane's turn grants it `weight` credits; one credit releases one
        request (EDF order within the lane).  Unspent deficit carries to the
        lane's next turn; a lane drained empty forfeits its deficit (classic
        DRR — credits never hoard while a class is idle).  Work-conserving:
        the loop only stops when max_items is reached or the queue is empty,
        so backlogged lanes always fill the whole allowance.
        """
        out: list[Request] = []
        while self._depth and len(out) < max_items:
            slo = self._rr[0]
            lane = self._lanes.get(slo)
            if not lane:
                # lane went idle: drop it from rotation (re-added on submit)
                self._deficits.pop(slo, None)
                self._turn_granted = False
                self._rr.popleft()
                continue
            if not self._turn_granted:
                self._deficits[slo] = self._deficits.get(slo, 0.0) + self._weight(slo)
                self._turn_granted = True
            while lane and self._deficits[slo] >= 1.0 and len(out) < max_items:
                out.append(self._pop_edf(lane))
                self._deficits[slo] -= 1.0
            if len(out) >= max_items and lane and self._deficits[slo] >= 1.0:
                break  # turn interrupted: keep position + remaining deficit
            if not lane:
                self._deficits.pop(slo, None)
            self._turn_granted = False
            self._rr.rotate(-1)
        return out

    def drain(self, max_items: int, timeout_s: float) -> list[Request]:
        """Pop up to max_items requests, blocking up to timeout_s for the first.

        Requests come out in drain order — priority descending, earliest
        deadline first within a priority, then admission order — or in
        deficit-round-robin order when `class_weights` is set (per-class
        share proportional to weight, EDF within a class).  Returns [] on
        timeout or when the queue is closed and empty.
        """
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._depth and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
            if self.class_weights is not None:
                return self._drain_drr(max_items)
            out = []
            while self._depth and len(out) < max_items:
                out.append(self._pop_next())
            return out

    def depth(self) -> int:
        """Number of requests currently waiting (the backpressure signal)."""
        with self._cond:
            return self._depth

    def depth_by_class(self) -> dict[str, int]:
        """Waiting requests per SLO class name (autoscaler/operator signal)."""
        with self._cond:
            return {slo.name: len(lane) for slo, lane in self._lanes.items() if lane}

    def slack_by_class(self, now: float | None = None) -> dict[str, float]:
        """Tightest remaining deadline headroom per queued SLO class.

        For each class with queued deadline-bearing requests, the minimum
        of (deadline_t - now) over its lane — negative means the class's
        earliest deadline already passed while queued.  Deadline-free
        classes are absent.  The autoscaler's cost signal: shrinking slack
        predicts a budget breach *before* anything expires.
        """
        now = time.monotonic() if now is None else now
        with self._cond:
            out: dict[str, float] = {}
            for slo, lane in self._lanes.items():
                slacks = [r.deadline_t - now for r in lane if r.deadline_t is not None]
                if slacks:
                    out[slo.name] = min(slacks)
            return out

    @property
    def closed(self) -> bool:
        """Whether close() ran — further submits raise QueueClosed."""
        with self._cond:
            return self._closed

    def close(self) -> list[Request]:
        """Refuse new admissions and return whatever was still queued.

        Leftovers come back in drain order.  The runtime flushes them
        through one final scheduling pass (drain=True) or cancels them
        (drain=False).
        """
        with self._cond:
            self._closed = True
            left = []
            while self._depth:
                left.append(self._pop_next())
            self._lanes.clear()
            self._cond.notify_all()
            return left
