"""Replica autoscaling — a control loop over queue depth and pool health.

The replica pool (serve/dispatch.py) detects failures and evicts; this
module closes the loop.  A background thread watches two signals:

  * **health** — replicas evicted by the liveness monitors (or chaos kills)
    are re-admitted via `ReplicaPool.rejoin` after a short delay, warm:
    every registered (bucket, policy) warmup batch replays on the fresh
    replica, capturing its CUDA graphs on the card, and the preprocess
    cache's hottest entries are pre-staged on its device before dispatch
    sees it.  Replicas the autoscaler itself
    retired (`Replica.retired`) are exempt — scale-down must not fight the
    rejoin loop.
  * **load** — admission-queue depth per alive replica.  Sustained depth
    above `scale_up_depth` revives a retired slot (or grows the pool up to
    `max_replicas`); depth at or below `scale_down_depth` for
    `scale_down_ticks` consecutive polls retires the highest-numbered
    replica down to `min_replicas`.  Every scale action starts a cooldown
    so the loop cannot flap; fault rejoins ignore the cooldown — recovery
    is not a scaling decision.
  * **cost** (opt-in) — deadline slack and shed rate.  Queue depth is a
    lagging proxy: a shallow queue of about-to-expire interactive requests,
    or a queue kept artificially short by admission shedding, both look
    healthy to the depth trigger.  With `slack_scale_up_s` set, any class
    whose tightest queued deadline is closer than the threshold triggers
    growth (reason ``"slack:<class>"``); with `shed_scale_up_rate` set, a
    shed rate above the threshold does (reason ``"shed"``).  Every
    `ScaleEvent` carries the `reason` that fired it.

Every action lands in `events` (`ScaleEvent`) for tests and the chip smoke
script to assert on.  The loop never raises: a failed action (e.g. a
rejoin whose warmup replay fails) is recorded as an ``"error"`` event and
retried on a later poll.
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs of the autoscaler control loop.

    Depth thresholds are per ALIVE replica — the signal is "how much
    backlog each healthy replica is carrying", so the thresholds keep their
    meaning as the pool grows and shrinks.  `max_replicas=None` caps
    scale-up at the pool's current slot count (only retired slots are
    revived, the pool never grows new slots).
    """

    poll_interval_s: float = 0.05
    rejoin_delay_s: float = 0.2  # dwell after a fault eviction before rejoin
    scale_up_depth: float = 8.0  # queue depth per alive replica that triggers growth
    scale_down_depth: float = 1.0  # depth per replica considered "shallow"
    scale_down_ticks: int = 20  # consecutive shallow polls before retiring one
    min_replicas: int = 1
    max_replicas: int | None = None
    cooldown_s: float = 1.0  # quiet period after any scale action
    # cost signals (None = depth-only triggering, the pre-existing default)
    slack_scale_up_s: float | None = None  # tightest queued deadline slack
    shed_scale_up_rate: float | None = None  # shed requests/s that trigger growth

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError("poll_interval_s must be > 0")
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas is not None and self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.scale_down_depth > self.scale_up_depth:
            raise ValueError("scale_down_depth must be <= scale_up_depth")
        if self.slack_scale_up_s is not None and self.slack_scale_up_s <= 0:
            raise ValueError("slack_scale_up_s must be > 0 or None")
        if self.shed_scale_up_rate is not None and self.shed_scale_up_rate <= 0:
            raise ValueError("shed_scale_up_rate must be > 0 or None")


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler action: rejoin / scale_up / scale_down / error."""

    action: str
    replica_id: int  # -1 for errors without a specific replica
    depth: int  # queue depth observed when the action was taken
    t: float  # time.monotonic() at the action
    reason: str = ""  # signal that fired: "depth", "slack:<class>", "shed"


class Autoscaler:
    """Background control loop growing/shrinking one ReplicaPool.

    Owns a daemon thread between `start()` and `stop()`; all state it
    mutates on the pool goes through the pool's public rejoin/retire/
    add_replica surface, so the loop can be driven manually in tests via
    `poll_once()` without starting the thread.
    """

    def __init__(self, pool, queue, config: AutoscalerConfig | None = None,
                 *, tracer=None, metrics=None):
        self.pool = pool
        self.queue = queue
        self.config = config or AutoscalerConfig()
        self.tracer = tracer  # Tracer | None — scale actions fold into the trace
        self.metrics = metrics  # ServeMetrics | None — shed-rate cost signal
        self.events: list[ScaleEvent] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cooldown_until = 0.0
        self._shallow_ticks = 0
        self._shed_mark: tuple[int, float] | None = None  # (count, t) last poll

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Autoscaler":
        """Spawn the polling thread (idempotent); returns self."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="pc2im-autoscaler"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the polling thread and wait for it to exit."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            self.poll_once()

    # -- one control step -----------------------------------------------------

    # trace-event names per action, literal so the registry scan sees them
    _TRACE_EVENTS = {
        "rejoin": "scale.rejoin",
        "scale_up": "scale.up",
        "scale_down": "scale.down",
        "error": "scale.error",
    }

    def _record(self, action: str, rid: int, depth: int, reason: str = "") -> None:
        with self._lock:
            self.events.append(
                ScaleEvent(action, rid, depth, time.monotonic(), reason)
            )
        if self.tracer is not None:
            self.tracer.emit(
                self._TRACE_EVENTS[action],
                replica_id=rid,
                args={"depth": depth, "reason": reason},
            )

    def poll_once(self) -> None:
        """One control step: rejoin the dead, then scale on depth + cost.

        Public so tests can drive the loop deterministically; the polling
        thread calls it every `poll_interval_s`.  Never raises.
        """
        try:
            depth = self.queue.depth()
        except Exception:  # noqa: BLE001 — queue closed mid-shutdown
            return
        now = time.monotonic()
        pressure = self._cost_pressure(now)  # sampled every poll: the shed
        # rate window must keep moving even through the cooldown
        self._rejoin_dead(now, depth)
        if now >= self._cooldown_until:
            self._scale(now, depth, pressure)

    def _cost_pressure(self, now: float) -> str | None:
        """Cost-signal scale-up reason, or None when no signal fires."""
        cfg = self.config
        if cfg.slack_scale_up_s is not None:
            try:
                slack = self.queue.slack_by_class(now)
            except Exception:  # noqa: BLE001 — queue closed mid-shutdown
                slack = {}
            for name in sorted(slack, key=lambda n: slack[n]):
                if slack[name] < cfg.slack_scale_up_s:
                    return f"slack:{name}"
        if cfg.shed_scale_up_rate is not None and self.metrics is not None:
            count = self.metrics.shed
            mark = self._shed_mark
            self._shed_mark = (count, now)
            if mark is not None and now > mark[1]:
                rate = (count - mark[0]) / (now - mark[1])
                if rate > cfg.shed_scale_up_rate:
                    return "shed"
        return None

    def _rejoin_dead(self, now: float, depth: int) -> None:
        """Re-admit fault-evicted replicas once their dwell elapsed.

        Outside the cooldown on purpose: a rejoin restores capacity the
        load signal already assumed — deferring it would double the outage.
        """
        for rep in list(self.pool.replicas):
            if rep.alive or rep.retired:
                continue
            if rep.evicted_t is None or now - rep.evicted_t < self.config.rejoin_delay_s:
                continue
            try:
                if self.pool.rejoin(rep.id):
                    self._record("rejoin", rep.id, depth)
            except Exception:  # noqa: BLE001 — warmup replay failed; retry later
                self._record("error", rep.id, depth)

    def _scale(self, now: float, depth: int, pressure: str | None = None) -> None:
        alive = self.pool.alive_replicas()
        if not alive:
            return  # nothing to scale against; rejoin handles recovery
        per_replica = depth / len(alive)
        if per_replica >= self.config.scale_up_depth:
            self._shallow_ticks = 0
            self._scale_up(now, depth, n_alive=len(alive), reason="depth")
            return
        if pressure is not None:
            # a cost signal overrides the shallow-depth read: the queue may
            # be short precisely BECAUSE requests are being shed or expiring
            self._shallow_ticks = 0
            self._scale_up(now, depth, n_alive=len(alive), reason=pressure)
            return
        if per_replica > self.config.scale_down_depth:
            self._shallow_ticks = 0
            return
        self._shallow_ticks += 1
        if (
            self._shallow_ticks >= self.config.scale_down_ticks
            and len(alive) > self.config.min_replicas
        ):
            self._shallow_ticks = 0
            victim = max(alive, key=lambda r: r.id)
            if self.pool.retire(victim.id):
                self._record("scale_down", victim.id, depth, "depth")
                self._cooldown_until = now + self.config.cooldown_s

    def _scale_up(self, now: float, depth: int, *, n_alive: int,
                  reason: str = "depth") -> None:
        cap = (
            self.config.max_replicas
            if self.config.max_replicas is not None
            else len(self.pool.replicas)
        )
        if n_alive >= cap:
            return
        try:
            # a retired slot is the cheap revival; only grow past the
            # existing slots when none is available and the cap allows
            for rep in self.pool.replicas:
                if not rep.alive and rep.retired:
                    if self.pool.rejoin(rep.id):
                        self._record("scale_up", rep.id, depth, reason)
                        self._cooldown_until = now + self.config.cooldown_s
                    return
            if len(self.pool.replicas) < cap:
                rid = self.pool.add_replica()
                self._record("scale_up", rid, depth, reason)
                self._cooldown_until = now + self.config.cooldown_s
        except Exception:  # noqa: BLE001 — warmup failed; retry next poll
            self._record("error", -1, depth, reason)
