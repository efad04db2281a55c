"""Decision audit log of the adaptive controller.

Every knob change (and every rollback) the controller performs lands here as
a frozen `Decision` carrying the evidence that justified it — the
`ScaleEvent` pattern from serve/autoscaler.py applied to knob tuning, so
tests and the chip smoke script can assert not just *that* the
controller converged but *why* each actuation happened.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class Decision:
    """One controller decision: a proposed knob change and its disposition.

    `kind` is the knob ("buckets" / "max_batch" / "max_wait"), or
    "rollback" (a reverted swap) or "error" (a failed actuation, never
    raised into the control thread).  `value` is the proposed setting,
    `previous` what it replaced; `applied` is False for proposals the
    hysteresis guard rejected.  `evidence` carries the observed numbers the
    proposal was computed from (quantiles, padding waste, occupancy, p95);
    `version` is the scheduler-config version the actuation produced (-1
    when nothing was applied).
    """

    kind: str
    value: object
    previous: object
    applied: bool
    reason: str
    evidence: Mapping[str, object]
    t: float
    version: int = -1


class DecisionLog:
    """Thread-safe append-only log of controller decisions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._decisions: list[Decision] = []

    def record(
        self,
        kind: str,
        *,
        value: object,
        previous: object,
        applied: bool,
        reason: str,
        evidence: Mapping[str, object] | None = None,
        version: int = -1,
    ) -> Decision:
        """Append one decision (stamped now); returns it."""
        d = Decision(
            kind=kind,
            value=value,
            previous=previous,
            applied=applied,
            reason=reason,
            evidence=dict(evidence or {}),
            t=time.monotonic(),
            version=version,
        )
        with self._lock:
            self._decisions.append(d)
        return d

    def all(self) -> tuple[Decision, ...]:
        """Every recorded decision, in order."""
        with self._lock:
            return tuple(self._decisions)

    def applied(self, kind: str | None = None) -> tuple[Decision, ...]:
        """Actuated decisions only, optionally filtered by kind."""
        with self._lock:
            return tuple(
                d
                for d in self._decisions
                if d.applied and (kind is None or d.kind == kind)
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._decisions)
