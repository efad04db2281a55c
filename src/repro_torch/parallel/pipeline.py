"""Host-level two-stage pipeline schedule (the port's `two_stage_schedule`).

The PipelinedExecutor (core/accelerator.py) and nothing else uses it: a
producer thread runs stage A over the items while the caller's thread runs
stage B, with a bounded hand-off queue between them.  The JAX package's
shard_map pipeline (`pipeline_forward`) comes with the multi-device slice.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Sequence

def two_stage_schedule(
    stage_a: Callable,
    stage_b: Callable,
    items: Sequence,
    *,
    depth: int = 2,
) -> list:
    """GPipe's fill-drain schedule for two stages, expressed at the host level.

    A producer thread runs ``stage_a`` over ``items`` in order, feeding a
    bounded hand-off queue of ``depth`` slots (double buffering by default);
    the caller's thread drains it and runs ``stage_b``.  While item k sits in
    stage B, item k+1 is already inside stage A.  On one card the overlap of
    the two stages' device work comes from the stage callables enqueueing
    on two CUDA streams (neither thread synchronises the device); when
    they pin their work to different devices it is two-device pipeline
    parallelism.

    Returns ``[stage_b(stage_a(item)) for item in items]`` in item order.
    The first exception from either stage propagates to the caller; the
    bounded queue caps live stage-A output at ``depth + 2`` items (``depth``
    queued, one being produced, one being consumed), so a long stream never
    accumulates unbounded intermediates.
    """
    items = list(items)
    if not items:
        return []
    handoff: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def produce():
        for i, item in enumerate(items):
            if stop.is_set():
                return
            try:
                out = stage_a(item)
            except Exception as e:  # noqa: BLE001 — relayed to the consumer
                handoff.put((i, None, e))
                return
            handoff.put((i, out, None))

    producer = threading.Thread(
        target=produce, name="two-stage-pipeline-a", daemon=True
    )
    producer.start()

    results: list = [None] * len(items)
    error: Exception | None = None
    for _ in range(len(items)):
        i, val, err = handoff.get()
        if err is not None:
            error = err
            break
        try:
            results[i] = stage_b(val)
        except Exception as e:  # noqa: BLE001 — drain the producer, then raise
            error = e
            break
    if error is not None:
        stop.set()
        while producer.is_alive():  # unblock a producer stuck on a full queue
            try:
                handoff.get(timeout=0.01)
            except queue_mod.Empty:
                pass
        producer.join()
        raise error
    producer.join()
    return results
