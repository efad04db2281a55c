"""SLO classes — named service levels with priority, deadline and shed policy.

PC2IM targets latency-bound perception, but not every request in a serving
mix is latency-bound: an interactive perception query (a vehicle waiting on
an obstacle answer) and a bulk re-indexing sweep can share one runtime, and
treating them identically makes the bulk traffic's backlog the interactive
traffic's tail latency.  An `SLOClass` names one service level and carries
everything the control plane needs to treat it differently:

  * `priority` — drain and batch-assembly order.  The admission queue
    releases higher-priority requests first (`serve/queue.py`), and the
    scheduler flushes higher-priority batch groups first
    (`serve/scheduler.py`).
  * `deadline_s` — the class's default per-request deadline; requests
    submitted without an explicit `timeout_s` inherit it.  Within one
    priority the queue drains earliest-deadline-first, so the classic
    EDF schedule emerges per class.
  * `sheddable` — the load-shedding contract.  Under backlog the queue
    rejects sheddable admissions with `Shed` (serve/queue.py) and, when
    completely full, evicts queued sheddable requests to admit
    higher-priority traffic; a non-sheddable class is only ever refused
    when the queue is full of equal-or-higher-priority work.
  * `max_wait_s` — an optional per-class bound on the scheduler's partial
    batch flush wait, so a latency-bound class never waits the global
    `max_wait_s` for stragglers to fill its batch.

Classes are frozen and hashable: the scheduler keys micro-batches by
`(bucket, policy, slo)`, so a batch never mixes classes — an interactive
batch never waits on a bulk flush timer, and per-batch metrics stay
attributable.  Two presets cover the common split (`INTERACTIVE`, `BULK`);
`DEFAULT` is the implicit class of unclassed traffic, shaped exactly like
the pre-SLO runtime behaved (priority 0, no deadline, sheddable).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One named service level: priority, default deadline, shed policy.

    Frozen and hashable so it can participate in the scheduler's
    micro-batch key — requests batch together only within one class.
    `priority` is higher-wins (any ints; presets use 0 for default
    traffic); `deadline_s` is the default per-request timeout (None = no
    deadline); `sheddable=False` exempts the class from load shedding;
    `max_wait_s` optionally tightens the scheduler's partial-batch flush
    wait for this class.
    """

    name: str
    priority: int = 0
    deadline_s: float | None = None
    sheddable: bool = True
    max_wait_s: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLOClass needs a non-empty name")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")
        if self.max_wait_s is not None and self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")


# The implicit class of unclassed traffic — shaped exactly like the pre-SLO
# runtime (priority 0, no default deadline, sheddable), so a runtime that
# never mentions SLO classes behaves as before.
DEFAULT = SLOClass("default")

# Presets for the common two-way split; callers needing different budgets
# construct their own SLOClass (any number of classes works).
INTERACTIVE = SLOClass(
    "interactive", priority=10, deadline_s=0.5, sheddable=False, max_wait_s=0.002
)
BULK = SLOClass("bulk", priority=-10, deadline_s=None, sheddable=True)


def drain_key(priority: int, deadline_t: float | None, seq: int) -> tuple:
    """Total drain order of one queued request — smaller drains first.

    Priority descending, then earliest absolute deadline (None sorts
    last), then admission order.  Shared by the admission queue's release
    loop and the tests that pin the property.
    """
    return (-priority, math.inf if deadline_t is None else deadline_t, seq)
