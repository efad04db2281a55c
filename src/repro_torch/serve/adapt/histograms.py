"""Online workload summaries + pure knob-proposal math.

Everything here is deterministic and side-effect free: the
`AdaptiveController` feeds it reservoir snapshots from `ServeMetrics` and
gets back proposed knob values plus the evidence (quantiles, padding waste)
that justified them.  Keeping the math pure lets tests pin the proposals on
synthetic distributions without a runtime, and lets the decision log carry
the exact numbers an operator needs to audit an actuation.
"""

from __future__ import annotations

import collections
from typing import Sequence

import numpy as np

from repro_torch.serve.scheduler import bucket_for


class Histogram:
    """Exact online histogram over small positive integers (request sizes).

    Point-cloud request sizes are small ints (hundreds to a few thousand),
    so exact per-value counts stay tiny; `quantile` reads the empirical CDF
    directly.  Used by the controller as the long-lived size summary that
    outlives the metrics reservoir's rotation.
    """

    def __init__(self):
        self._counts: collections.Counter[int] = collections.Counter()
        self._n = 0

    def add(self, value: int, count: int = 1) -> None:
        """Count `count` observations of `value` (must be > 0)."""
        if value <= 0:
            raise ValueError(f"histogram values must be > 0, got {value}")
        self._counts[int(value)] += count
        self._n += count

    def extend(self, values: Sequence[int]) -> None:
        """Count every value in `values`."""
        for v in values:
            self.add(int(v))

    def __len__(self) -> int:
        return self._n

    def quantile(self, q: float) -> int:
        """Smallest observed value v with CDF(v) >= q (empirical quantile)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self._n == 0:
            raise ValueError("quantile of an empty histogram")
        target = q * self._n
        acc = 0
        for v in sorted(self._counts):
            acc += self._counts[v]
            if acc >= target:
                return v
        return max(self._counts)

    def mean(self) -> float:
        """Mean of the observed values (0.0 when empty)."""
        if self._n == 0:
            return 0.0
        return sum(v * c for v, c in self._counts.items()) / self._n


def padding_waste(sizes: np.ndarray, buckets: Sequence[int]) -> float:
    """Mean fraction of each padded batch row that is filler, over `sizes`.

    A size-s request served at bucket b computes b rows of which only
    min(s, b) are real — the rest is padding the accelerator still pays
    for.  Oversized clouds subsample down to the largest bucket and waste
    nothing.  This is the objective the bucket proposal minimizes.
    """
    if len(sizes) == 0:
        return 0.0
    waste = []
    for s in np.asarray(sizes, np.int64):
        b = bucket_for(int(s), buckets)
        waste.append((b - min(int(s), b)) / b)
    return float(np.mean(waste))


def propose_buckets(
    sizes: np.ndarray,
    n_buckets: int,
    *,
    align: int = 32,
    min_bucket: int,
    max_bucket: int,
) -> tuple[int, ...]:
    """Quantile-based bucket boundaries over an observed size distribution.

    Boundaries sit at the size quantiles q = i/n_buckets (i = 1..n_buckets),
    rounded UP to `align` (so every cloud at or below the quantile fits) and
    clamped to [min_bucket, max_bucket].  The largest bucket is always
    `max_bucket` — the proposal refines *within* the configured envelope, so
    every size servable before a swap stays servable after it (the
    `oversize="reject"` contract cannot tighten under adaptation).
    Duplicate boundaries collapse; the result is sorted and unique.
    """
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    if not (0 < min_bucket <= max_bucket):
        raise ValueError(
            f"need 0 < min_bucket <= max_bucket, got {min_bucket}, {max_bucket}"
        )
    sizes = np.asarray(sizes, np.int64)
    if sizes.size == 0:
        return (max_bucket,)
    out = set()
    for i in range(1, n_buckets + 1):
        # method="lower": an OBSERVED size, not an interpolated midpoint —
        # on a bimodal distribution the boundary sits on a mode, so the
        # aligned bucket hugs the sizes it will actually serve
        q = float(np.quantile(sizes, i / n_buckets, method="lower"))
        b = int(-(-q // align) * align)  # ceil to alignment
        out.add(max(min_bucket, min(max_bucket, b)))
    out.add(max_bucket)
    return tuple(sorted(out))


def interarrival_mean(arrivals: np.ndarray, window: int = 256) -> float | None:
    """Mean inter-arrival gap (s) over the newest `window` admissions.

    None when fewer than two arrivals are retained — no rate estimate.
    """
    arrivals = np.asarray(arrivals, np.float64)
    if arrivals.size < 2:
        return None
    tail = arrivals[-window:]
    if tail.size < 2:
        return None
    return float(np.mean(np.diff(tail)))


def propose_wait(
    gap_s: float | None,
    max_batch: int,
    *,
    bounds: tuple[float, float],
) -> float | None:
    """Batching patience from the arrival rate: time to fill one batch.

    Waiting much longer than (max_batch - 1) gaps buys no occupancy (the
    batch is already full) and waiting much less flushes half-empty; the
    proposal is that fill time clamped to `bounds`.  None when no rate
    estimate exists.
    """
    if gap_s is None or max_batch < 1:
        return None
    lo, hi = bounds
    return float(min(hi, max(lo, (max_batch - 1) * gap_s)))
