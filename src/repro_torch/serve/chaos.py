"""Deterministic fault injection for the serving replica pool.

Recovery behavior — eviction, batch re-dispatch, autoscaler rejoin — is only
trustworthy if it is exercised, and real faults are rare and unreproducible.
A `ChaosInjector` attaches to a `ReplicaPool` and observes every REAL batch
(warmup batches, `n_real == 0`, are invisible) at execution start on the
owning replica's worker thread — the single choke point both the sequential
and pipelined paths pass through.  Faults are declared up front as
`(replica, batch index, kind)` triples, so a test or benchmark states
exactly "kill replica 1 at its 3rd real batch" and gets the same failure on
every run:

  * `kill` — the replica is evicted on the spot (its in-flight batches
    re-dispatch to the survivors) and the executing batch aborts; this is
    the instant-crash fault the autoscaler's rejoin loop recovers from.
  * `wedge` — the worker thread sleeps past the heartbeat timeout, so the
    pump's beats queue behind it and the liveness monitor evicts the
    replica: the hung-kernel fault, detected the same way production would.
  * `slow` — a bounded sleep; the replica stays alive and the straggler
    monitor records it.

Every firing is logged in `events` (kind, replica, per-replica batch index,
monotonic time) for assertions.  Injection is observation-only bookkeeping
plus the declared fault — an injector with no matching fault adds two dict
lookups per batch.
"""

from __future__ import annotations

import dataclasses
import threading
import time


class ChaosError(RuntimeError):
    """Raised into the executing batch when an injected fault aborts it.

    The pool's retry logic treats it like any device failure — except after
    a `kill`, where eviction already re-dispatched the batch and the
    was_inflight guard keeps the abort from dispatching it a second time.
    """


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declared fault: which replica, which batch, what happens.

    `at_batch` counts REAL batches executed by that replica (0-based;
    warmup batches don't count), so the firing point is deterministic for a
    given dispatch order.  `duration_s` is the sleep for wedge/slow faults
    — a wedge must exceed the pool's heartbeat timeout to trip eviction.
    Each fault fires at most once.
    """

    replica_id: int
    at_batch: int
    kind: str = "kill"  # "kill" | "wedge" | "slow"
    duration_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("kill", "wedge", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at_batch < 0:
            raise ValueError(f"at_batch must be >= 0, got {self.at_batch}")
        if self.kind in ("wedge", "slow") and self.duration_s <= 0:
            raise ValueError(f"{self.kind} fault needs duration_s > 0")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One fault firing, logged for test/benchmark assertions."""

    kind: str
    replica_id: int
    batch_index: int  # the replica's real-batch count when the fault fired
    t: float  # time.monotonic() at firing


class ChaosInjector:
    """Replays declared faults against a live ReplicaPool, deterministically.

    `attach(pool)` installs the injector as the pool's `chaos` hook; the
    pool then calls `on_batch` for every real batch before executing it.
    Thread-safe: replicas fire faults from their own worker threads.
    """

    def __init__(self, faults: list[Fault] | tuple[Fault, ...] = ()):
        self.faults = list(faults)
        self.events: list[ChaosEvent] = []
        self._counts: dict[int, int] = {}
        self._fired: set[int] = set()  # indexes into self.faults
        self._lock = threading.Lock()

    def attach(self, pool) -> "ChaosInjector":
        """Install on one ReplicaPool (returns self for chaining)."""
        pool.chaos = self
        return self

    def add(self, fault: Fault) -> None:
        """Declare one more fault (usable mid-run)."""
        with self._lock:
            self.faults.append(fault)

    def on_batch(self, pool, rep, mb) -> None:
        """Pool hook: one real batch is about to execute on `rep`.

        Counts the batch, fires at most one matching un-fired fault.  Runs
        on the replica's worker thread; sleeps (wedge/slow) therefore block
        exactly the thread a real hang would block.
        """
        with self._lock:
            index = self._counts.get(rep.id, 0)
            self._counts[rep.id] = index + 1
            fault = None
            for i, f in enumerate(self.faults):
                if (
                    i not in self._fired
                    and f.replica_id == rep.id
                    and f.at_batch == index
                ):
                    self._fired.add(i)
                    fault = f
                    break
            if fault is not None:
                self.events.append(
                    ChaosEvent(fault.kind, rep.id, index, time.monotonic())
                )
        if fault is None:
            return
        tracer = getattr(pool, "tracer", None)
        if tracer is not None:
            # literal names so the closed-registry scan sees them
            name = {"kill": "chaos.kill", "wedge": "chaos.wedge",
                    "slow": "chaos.slow"}[fault.kind]
            tracer.emit(
                name,
                replica_id=rep.id,
                batch_id=getattr(mb, "batch_id", -1),
                args={"batch_index": index, "duration_s": fault.duration_s},
            )
        if fault.kind == "kill":
            # eviction re-dispatches every in-flight batch (including this
            # one); the abort below must then NOT retry it again — the
            # pool's was_inflight guard arbitrates
            pool.evict(rep.id, reason="chaos-kill")
            raise ChaosError(f"replica {rep.id} killed at batch {index}")
        if fault.kind == "wedge":
            # block the worker thread past the heartbeat timeout: the pump's
            # beats queue up behind this sleep and the monitor evicts us —
            # the detection path itself is what's under test
            time.sleep(fault.duration_s)
            if not rep.alive:  # the monitor fired, as intended
                raise ChaosError(
                    f"replica {rep.id} wedged at batch {index} and was evicted"
                )
            return  # liveness disabled: the wedge was only a delay
        time.sleep(fault.duration_s)  # "slow": straggle but survive

    def fired(self, kind: str | None = None) -> list[ChaosEvent]:
        """Events so far, optionally filtered by fault kind."""
        with self._lock:
            return [e for e in self.events if kind is None or e.kind == kind]
