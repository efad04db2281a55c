"""Request-lifecycle span tracer for the serving stack.

Every request admitted through :meth:`ServingRuntime.submit` is assigned a
trace id, and each lifecycle edge — admission, lane enqueue, drain, batch
assembly, cache probes, dispatch, the preprocess/feature execution stages
and exactly one terminal outcome — emits a typed :class:`TraceEvent` into a
fixed-capacity ring buffer.  Batch-level spans carry their own ids and are
linked to member requests through the ``members`` arg of ``batch.assembled``;
control-plane activity (autoscaler actions, replica eviction/rejoin, chaos
faults, straggler beats, cache churn) folds into the same stream so a single
export shows the request timeline against the events that shaped it.

Design constraints, in order:

* **Off is free.**  Components hold ``tracer: Tracer | None`` and every
  instrumentation site is a single ``if tracer is not None`` branch — no
  event objects, no lock traffic, nothing allocated when tracing is off.
* **On is cheap.**  ``emit`` builds one small frozen dataclass and appends
  it to a ``deque(maxlen=capacity)`` under one uncontended lock; the ring
  silently drops the oldest events instead of growing or blocking.
* **The event namespace is closed.**  Every event name is declared exactly
  once in :data:`EVENTS`; ``emit`` rejects undeclared names and a tier-1
  test greps the serve sources to keep call sites and registry in sync.

Sampling is head-based and per trace id: :meth:`Tracer.new_trace` decides
once, at submit, whether a request is traced (``None`` means sampled out)
and every later hook site skips request-scoped events for untraced requests.
Batch and control-plane events are not sampled — they are few and they are
the frame of reference the sampled requests hang off.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

# --------------------------------------------------------------------------
# Event-name registry.  CLOSED: every name emitted anywhere in repro_torch.serve
# (subpackages included) or by the graph layer (core/graphs.py, which is
# handed a Tracer inside graphs.traced) must be declared here exactly once
# (tests/test_torch_serve.py checks both directions).  Names are
# "<scope>.<edge>"; scopes are:
#   request.* — events on one request's span (trace_id set)
#   batch.*   — events on one micro-batch's span (batch_id set)
#   graph.*   — the graph layer's replays and captures, on the batch that
#               caused them (batch_id -1 outside a served batch)
#   replica.* / scale.* / chaos.* / cache.* / adapt.* — control-plane stream
# --------------------------------------------------------------------------
EVENTS: tuple[str, ...] = (
    # request lifecycle
    "request.submit",
    "request.admitted",
    "request.enqueued",
    "request.drained",
    "request.assembled",
    "request.cache_peek",
    "request.cache_lookup",
    # request terminals (exactly one per trace; see TERMINAL_EVENTS)
    "request.completed",
    "request.rejected",
    "request.shed",
    "request.expired",
    "request.failed",
    # micro-batch span
    "batch.assembled",
    "batch.dispatched",
    "batch.retry",
    "batch.execute_start",
    "batch.execute_end",
    "batch.cache_start",
    "batch.cache_end",
    "batch.preprocess_start",
    "batch.preprocess_end",
    "batch.splice_start",
    "batch.splice_end",
    "batch.feature_start",
    "batch.feature_end",
    "batch.completed",
    "batch.failed",
    # graph layer: a replay's host span (the times of its parts in
    # replay_end's args), the card's times of the stages a
    # traced capture marked, and a capture
    "graph.replay_end",
    "graph.stage_times",
    "graph.captured",
    # control plane
    "replica.evicted",
    "replica.rejoin",
    "replica.straggler",
    "scale.up",
    "scale.down",
    "scale.rejoin",
    "scale.error",
    "chaos.kill",
    "chaos.wedge",
    "chaos.slow",
    "cache.insert",
    "cache.evict",
    # adaptive control plane (serve/adapt): knob proposals and actuations
    "adapt.propose",
    "adapt.apply",
    "adapt.rollback",
)

_EVENT_SET = frozenset(EVENTS)

#: The five mutually-exclusive ways a request span ends.  A well-formed
#: trace contains exactly one of these per trace id (asserted in tests and
#: checked by :func:`repro_torch.serve.obs.request_timelines`).
TERMINAL_EVENTS = frozenset(
    {
        "request.completed",
        "request.rejected",
        "request.shed",
        "request.expired",
        "request.failed",
    }
)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for the tracer; absence of a config means tracing is off.

    ``capacity`` bounds the ring buffer (oldest events drop first — sized
    for minutes of serving at default rates).  ``sample`` is the head-
    sampling fraction in [0, 1]: the keep/drop decision is made once per
    trace id at submit, deterministically, so a request is either fully
    traced or fully absent — never a partial span.
    """

    capacity: int = 65536
    sample: float = 1.0


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One typed edge in the trace stream.

    ``t`` is ``time.monotonic()`` seconds.  ``trace_id``/``batch_id``/
    ``replica_id`` are -1 when the event is not scoped to that axis; ``slo``
    is the SLO class name for request-scoped events and ``args`` carries
    small event-specific details (hit flags, member lists, reasons).
    """

    name: str
    t: float
    trace_id: int = -1
    batch_id: int = -1
    replica_id: int = -1
    slo: str = ""
    args: dict | None = None


def _keep(trace_id: int, sample: float) -> bool:
    """Deterministic head-sampling decision for one trace id.

    Fibonacci-hashes the id so bursts of consecutive ids spread uniformly
    over [0, 1) instead of aliasing against the arrival pattern.
    """
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    return ((trace_id * 2654435761) & 0xFFFFFFFF) / 2**32 < sample


class Tracer:
    """Thread-safe ring-buffered sink for :class:`TraceEvent` records.

    One instance per :class:`~repro_torch.serve.runtime.ServingRuntime`; shared by
    the queue, scheduler, replica pool, cache, autoscaler and chaos injector.
    All methods are safe to call from any thread.
    """

    def __init__(self, config: TraceConfig | None = None):
        self.config = config or TraceConfig()
        self._lock = threading.Lock()
        self._deque = collections.deque(maxlen=max(1, self.config.capacity))
        self._trace_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        self._emitted = 0

    def new_trace(self) -> int | None:
        """Allocate a trace id, or ``None`` if head-sampled out.

        Called exactly once per submitted request.  A ``None`` return means
        no event of this request's span will ever be emitted; hook sites
        gate on ``req.trace_id is not None``.
        """
        tid = next(self._trace_ids)
        return tid if _keep(tid, self.config.sample) else None

    def next_batch_id(self) -> int:
        """Allocate a fresh micro-batch span id (batch spans never sample)."""
        return next(self._batch_ids)

    def emit(
        self,
        name: str,
        *,
        trace_id: int = -1,
        batch_id: int = -1,
        replica_id: int = -1,
        slo: str = "",
        args: dict | None = None,
        t: float | None = None,
    ) -> None:
        """Append one event to the ring; ``name`` must be declared in EVENTS.

        ``t`` defaults to ``time.monotonic()`` now; pass it explicitly when
        the edge was observed earlier than the emit (e.g. timestamps taken
        inside a lock and emitted after release).
        """
        if name not in _EVENT_SET:
            raise ValueError(f"undeclared trace event {name!r}")
        ev = TraceEvent(
            name,
            time.monotonic() if t is None else t,
            trace_id,
            batch_id,
            replica_id,
            slo,
            args,
        )
        with self._lock:
            self._deque.append(ev)
            self._emitted += 1

    def events(self) -> list[TraceEvent]:
        """Snapshot the ring contents, oldest first."""
        with self._lock:
            return list(self._deque)

    def clear(self) -> None:
        """Drop all buffered events (ids keep counting up)."""
        with self._lock:
            self._deque.clear()

    @property
    def emitted(self) -> int:
        """Total events emitted since construction (including dropped)."""
        with self._lock:
            return self._emitted

    @property
    def dropped(self) -> int:
        """Events lost to ring overflow so far."""
        with self._lock:
            return max(0, self._emitted - len(self._deque))

    def __len__(self) -> int:
        with self._lock:
            return len(self._deque)
