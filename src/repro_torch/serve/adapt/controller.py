"""AdaptiveController — the daemon closing the observe -> actuate loop.

A background thread (the `Autoscaler` pattern: start/stop lifecycle,
`poll_once` drivable from tests, never raises) that each tick:

1. **verifies** the last applied swap — if the post-swap windowed p95
   regressed past `rollback_factor` x the pre-swap p95, the previous knobs
   are re-applied (a "rollback" decision) and the controller cools down;
2. **proposes** new knob values from the observed workload —
   quantile-based bucket boundaries minimizing padding waste, `max_batch`
   from measured batch occupancy + backlog, per-class batching patience
   from per-class inter-arrival gaps (all pure math in
   serve/adapt/histograms.py);
3. **actuates** at most one accepted proposal per tick through
   `ServingRuntime.reconfigure` — which background-warms the new
   (bucket x policy x replica) shapes first (capturing their CUDA graphs
   on the card) and then atomically swaps
   the versioned `SchedulerConfig`, so traffic never pauses and no batch
   mixes shapes.

Hysteresis is explicit: a bucket proposal must improve predicted padding
waste by `waste_improvement`, occupancy must cross the high/low water marks
to move `max_batch`, and a patience override must shift by
`wait_rel_change`; every accepted AND rejected proposal lands in the
`DecisionLog` with its evidence, and every actuation emits `adapt.*` trace
events into the same stream the rest of the control plane reports to.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.serve.adapt.decisions import DecisionLog
from repro_torch.serve.adapt.histograms import (
    interarrival_mean,
    padding_waste,
    propose_buckets,
    propose_wait,
)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the adaptive controller itself.

    `min_bucket` / `max_bucket` bound the bucket proposal (None = the
    runtime's current smallest / largest bucket — adaptation then refines
    within the configured envelope and can never make a servable size
    unservable).  `observe_s` is the rollback-verification window after a
    swap: no further actuation happens inside it, and at its end the
    post-swap p95 is judged against `rollback_factor` x the pre-swap p95.
    `cooldown_s` is the quiet period after any actuation or rollback.
    """

    poll_interval_s: float = 0.25
    min_samples: int = 64  # size observations required before any proposal
    # bucket proposal
    tune_buckets: bool = True
    n_buckets: int = 2
    bucket_align: int = 32
    min_bucket: int | None = None
    max_bucket: int | None = None
    waste_improvement: float = 0.05  # required predicted waste reduction
    # max_batch proposal
    tune_max_batch: bool = True
    max_batch_bounds: tuple[int, int] = (2, 16)
    occupancy_high: float = 0.9  # batches this full + backlog -> grow
    occupancy_low: float = 0.3  # batches this empty -> shrink
    min_batch_records: int = 8
    # per-class batching patience proposal
    tune_wait: bool = True
    wait_bounds: tuple[float, float] = (0.001, 0.05)
    wait_rel_change: float = 0.25  # relative shift required to re-apply
    # rollback guard
    observe_s: float = 1.0
    rollback_factor: float = 1.5
    min_window_completions: int = 16
    cooldown_s: float = 1.0

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError("poll_interval_s must be > 0")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if self.n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        if not (0 < self.occupancy_low < self.occupancy_high <= 1.0):
            raise ValueError("need 0 < occupancy_low < occupancy_high <= 1")
        lo, hi = self.max_batch_bounds
        if not (1 <= lo <= hi):
            raise ValueError(f"bad max_batch_bounds {self.max_batch_bounds}")
        wlo, whi = self.wait_bounds
        if not (0 < wlo <= whi):
            raise ValueError(f"bad wait_bounds {self.wait_bounds}")
        if self.rollback_factor <= 1.0:
            raise ValueError("rollback_factor must be > 1")
        if self.observe_s <= 0 or self.cooldown_s < 0:
            raise ValueError("observe_s must be > 0 and cooldown_s >= 0")


class AdaptiveController:
    """Background feedback loop retuning one ServingRuntime's knobs.

    All actuation goes through `runtime.reconfigure` (the pause-free
    warm-then-swap path); every decision — applied, rejected or rolled
    back — is recorded in `decisions` with its evidence.  Drive manually
    in tests via `poll_once()`; the thread only adds periodicity.
    """

    def __init__(self, runtime, config: AdaptiveConfig | None = None):
        self.runtime = runtime
        self.config = config or AdaptiveConfig()
        self.decisions = DecisionLog()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cooldown_until = 0.0
        # (applied_t, revert kwargs for reconfigure, pre-swap p95 | None)
        self._pending_verify: tuple[float, dict, float | None] | None = None
        self._last_rejected: dict[str, object] = {}  # kind -> last logged value
        self._batch_marker = 0  # batch_records index at the last max_batch swap

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "AdaptiveController":
        """Spawn the polling thread (idempotent); returns self."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="pc2im-adapt"
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

    def poll_once(self) -> None:
        """One control step: verify the last swap, then propose/actuate.

        Never raises — a failed actuation is recorded as an "error"
        decision and retried from fresh evidence on a later tick.
        """
        try:
            self._step()
        except Exception as e:  # noqa: BLE001 — the loop must survive anything
            self.decisions.record(
                "error",
                value=None,
                previous=None,
                applied=False,
                reason=f"{type(e).__name__}: {e}",
            )

    def _emit(self, name: str, args: dict) -> None:
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None:
            tracer.emit(name, args=args)

    def _step(self) -> None:
        now = time.monotonic()
        if self._pending_verify is not None:
            if now < self._pending_verify[0] + self.config.observe_s:
                return  # inside the observation window: no further changes
            self._verify(now)
            return  # verification consumed this tick; propose from fresh state
        if now < self._cooldown_until:
            return
        metrics = self.runtime.metrics
        sizes = metrics.request_sizes()
        if sizes.size < self.config.min_samples:
            return
        # at most ONE actuation per tick, most valuable knob first: buckets
        # move the padded-compute floor, max_batch the amortization, waits
        # only the flush patience
        if self.config.tune_buckets and self._tune_buckets(now, sizes):
            return
        if self.config.tune_max_batch and self._tune_max_batch(now, metrics):
            return
        if self.config.tune_wait:
            self._tune_waits(now, metrics)

    # -- rollback guard -------------------------------------------------------

    def _verify(self, now: float) -> None:
        applied_t, revert, pre_p95 = self._pending_verify
        self._pending_verify = None
        post = self.runtime.metrics.latencies_since(applied_t)
        if (
            pre_p95 is None
            or post.size < self.config.min_window_completions
        ):
            return  # not enough evidence either side: keep the swap
        post_p95 = float(np.percentile(post, 95))
        if post_p95 <= self.config.rollback_factor * pre_p95:
            return
        version = self.runtime.reconfigure(**revert)
        self.decisions.record(
            "rollback",
            value=dict(revert),
            previous=None,
            applied=True,
            reason=(
                f"post-swap p95 {post_p95 * 1e3:.1f}ms > "
                f"{self.config.rollback_factor:g}x pre-swap {pre_p95 * 1e3:.1f}ms"
            ),
            evidence={"pre_p95_s": pre_p95, "post_p95_s": post_p95,
                      "window_n": int(post.size)},
            version=version,
        )
        self._emit("adapt.rollback", {
            "pre_p95_ms": pre_p95 * 1e3, "post_p95_ms": post_p95 * 1e3,
        })
        self._cooldown_until = now + self.config.cooldown_s

    def _actuate(self, kind: str, value, previous, reason: str,
                 evidence: dict, revert: dict, **kwargs) -> None:
        """Apply one accepted proposal and arm the rollback guard."""
        self._emit("adapt.propose", {"kind": kind, "value": str(value)})
        pre = self.runtime.metrics.latencies_since(
            time.monotonic() - self.config.observe_s
        )
        pre_p95 = (
            float(np.percentile(pre, 95))
            if pre.size >= self.config.min_window_completions
            else None
        )
        version = self.runtime.reconfigure(**kwargs)
        self.decisions.record(
            kind, value=value, previous=previous, applied=True,
            reason=reason, evidence=evidence, version=version,
        )
        self._emit("adapt.apply", {
            "kind": kind, "value": str(value), "version": version,
        })
        now = time.monotonic()
        self._pending_verify = (now, revert, pre_p95)
        self._cooldown_until = now + self.config.cooldown_s

    def _reject(self, kind: str, value, previous, reason: str,
                evidence: dict) -> None:
        """Log a proposal the hysteresis guard rejected (deduplicated)."""
        if self._last_rejected.get(kind) == value:
            return
        self._last_rejected[kind] = value
        self.decisions.record(
            kind, value=value, previous=previous, applied=False,
            reason=reason, evidence=evidence,
        )

    # -- knob proposals -------------------------------------------------------

    def _tune_buckets(self, now: float, sizes: np.ndarray) -> bool:
        cur = tuple(self.runtime.buckets)
        min_b = self.config.min_bucket if self.config.min_bucket is not None else cur[0]
        max_b = self.config.max_bucket if self.config.max_bucket is not None else cur[-1]
        proposed = propose_buckets(
            sizes, self.config.n_buckets,
            align=self.config.bucket_align, min_bucket=min_b, max_bucket=max_b,
        )
        if proposed == cur:
            return False
        cur_waste = padding_waste(sizes, cur)
        new_waste = padding_waste(sizes, proposed)
        evidence = {
            "observed_n": int(sizes.size),
            "size_p50": float(np.quantile(sizes, 0.5)),
            "size_p95": float(np.quantile(sizes, 0.95)),
            "waste_current": cur_waste,
            "waste_proposed": new_waste,
        }
        if cur_waste - new_waste < self.config.waste_improvement:
            self._reject(
                "buckets", proposed, cur,
                f"predicted waste gain {cur_waste - new_waste:.3f} < "
                f"hysteresis {self.config.waste_improvement:g}",
                evidence,
            )
            return False
        self._actuate(
            "buckets", proposed, cur,
            f"padding waste {cur_waste:.3f} -> {new_waste:.3f} on "
            f"{sizes.size} observed sizes",
            evidence, revert={"buckets": cur}, buckets=proposed,
        )
        return True

    def _tune_max_batch(self, now: float, metrics) -> bool:
        records = metrics.batch_records
        fresh = [
            b for b in records[self._batch_marker:] if b.n_real
        ]
        if len(fresh) < self.config.min_batch_records:
            return False
        occ = float(np.mean([b.n_real / b.batch_size for b in fresh]))
        cur = self.runtime.scheduler.config.max_batch
        lo, hi = self.config.max_batch_bounds
        depth = self.runtime.queue.depth()
        proposed = None
        if occ >= self.config.occupancy_high and depth >= cur and cur * 2 <= hi:
            proposed, why = cur * 2, (
                f"occupancy {occ:.2f} >= {self.config.occupancy_high:g} with "
                f"backlog {depth}"
            )
        elif occ <= self.config.occupancy_low and cur // 2 >= lo:
            proposed, why = cur // 2, (
                f"occupancy {occ:.2f} <= {self.config.occupancy_low:g}"
            )
        if proposed is None or proposed == cur:
            return False
        evidence = {"occupancy": occ, "queue_depth": depth,
                    "batches_observed": len(fresh)}
        self._batch_marker = len(records)
        self._actuate(
            "max_batch", proposed, cur, why, evidence,
            revert={"max_batch": cur}, max_batch=proposed,
        )
        return True

    def _tune_waits(self, now: float, metrics) -> bool:
        cur_cfg = self.runtime.scheduler.config
        current = dict(cur_cfg.class_max_wait)
        proposed = dict(current)
        evidence: dict[str, object] = {}
        need = max(8, self.config.min_samples // 4)
        for name, arrivals in metrics.arrivals_by_class().items():
            if arrivals.size < need:
                continue
            wait = propose_wait(
                interarrival_mean(arrivals), cur_cfg.max_batch,
                bounds=self.config.wait_bounds,
            )
            if wait is None:
                continue
            old = current.get(name)
            if old is not None and abs(wait - old) / old < self.config.wait_rel_change:
                continue
            proposed[name] = wait
            evidence[name] = {"wait_s": wait, "arrivals": int(arrivals.size)}
        if proposed == current:
            return False
        value = tuple(sorted(proposed.items()))
        self._actuate(
            "max_wait", value, tuple(sorted(current.items())),
            f"batching patience refit for {sorted(evidence)}",
            evidence, revert={"class_max_wait": tuple(sorted(current.items()))},
            class_max_wait=value,
        )
        return True
