"""Restart supervision, liveness and straggler detection.

The replica pool (serve/dispatch.py) drives both monitors with in-process
signals, and the training driver (launch/train.py) times its steps with
the straggler monitor and supervises its LM loop with the restart driver:

  run_with_restarts  — supervises a train loop; on any exception (a
      simulated preemption or device loss) it resumes from the newest
      complete checkpoint, up to max_restarts.  The data stream is
      step-keyed, so a restart replays the exact schedule.
  StragglerMonitor   — per-batch wall time against the running median;
      flags batches slower than `threshold` x the median (recorded and
      reported through a callback, never evicted).
  HeartbeatMonitor   — background liveness thread; a missed deadline invokes
      the on_dead callback (the pool evicts the replica).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    """One step (batch) slower than `threshold` x the running median."""

    step: int
    duration_s: float
    median_s: float
    ratio: float


class StragglerMonitor:
    """Per-step wall time against the median of the last `window` steps."""

    def __init__(self, threshold: float = 2.0, window: int = 64, on_straggler=None):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    def step_start(self):
        """Start timing one step."""
        self._t0 = time.monotonic()

    def step_end(self, step: int):
        """End the step started last; returns its duration in seconds.

        Once 8 steps are on record, a step slower than `threshold` x their
        median is recorded as a StragglerEvent and passed to `on_straggler`.
        """
        if self._t0 is None:
            raise RuntimeError("step_end called before step_start")
        dt = time.monotonic() - self._t0
        hist = self.durations[-self.window:]
        self.durations.append(dt)
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if med > 0 and dt > self.threshold * med:
                ev = StragglerEvent(step, dt, med, dt / med)
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
        return dt


class HeartbeatMonitor:
    """Calls `on_dead` once when no `beat()` came for `timeout_s` seconds."""

    def __init__(self, timeout_s: float, on_dead: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_dead = on_dead
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        """Start the watch thread; returns self."""
        self._thread.start()
        return self

    def beat(self):
        """Record that the watched thread is alive now."""
        self._last = time.monotonic()

    def stop(self):
        """Stop the watch thread (it exits within timeout_s / 4)."""
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.timeout_s / 4):
            if time.monotonic() - self._last > self.timeout_s and not self._fired:
                self._fired = True
                self.on_dead()


def run_with_restarts(make_state, train_loop, *, ckpt_manager, max_restarts: int = 3,
                      restore_device=None):
    """Supervise `train_loop(state, start_step) -> (state, last_step)`.

    make_state() builds a fresh state; where a complete checkpoint exists,
    `ckpt_manager.restore_or_none(state, device=restore_device)` replaces it
    (the reference's `restore_shardings` is the device here).  Returns
    (state, last_step, n_restarts); the exception of the restart past
    `max_restarts` propagates.
    """
    n_restarts = 0
    while True:
        state = make_state()
        start_step = 0
        restored = ckpt_manager.restore_or_none(state, device=restore_device)
        if restored is not None:
            state, start_step, _extra = restored
        try:
            state, last = train_loop(state, start_step)
            ckpt_manager.wait()
            return state, last, n_restarts
        except Exception:  # noqa: BLE001 — a simulated preemption or hardware loss
            n_restarts += 1
            if n_restarts > max_restarts:
                raise
            ckpt_manager.wait()
