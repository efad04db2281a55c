"""Adaptive serving control plane — observe, propose, warm, swap, verify.

The serving stack's knobs (bucket boundaries, ``max_batch``, per-class
batching patience) are static at construction; this package closes the loop
from the observability layer back to them.  `histograms` holds the online
workload summaries and the pure proposal math (quantile buckets, padding
waste, batching patience); `decisions` is the `ScaleEvent`-style audit log
explaining every actuation; `controller` is the `AdaptiveController` daemon
that periodically reads `ServeMetrics`, proposes new knobs, applies them
through `ServingRuntime.reconfigure` (warm-then-atomic-swap, so traffic
never pauses and no batch mixes shapes) and reverts a swap whose post-apply
p95 regresses.
"""

from repro_torch.serve.adapt.controller import AdaptiveConfig, AdaptiveController  # noqa: F401
from repro_torch.serve.adapt.decisions import Decision, DecisionLog  # noqa: F401
from repro_torch.serve.adapt.histograms import (  # noqa: F401
    Histogram,
    interarrival_mean,
    padding_waste,
    propose_buckets,
    propose_wait,
)
