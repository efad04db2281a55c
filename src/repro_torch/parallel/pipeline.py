"""Pipeline schedules: GPipe's fill-drain over stage devices, and its two-stage host form.

`pipeline_forward` runs microbatches through `n_stages` sequential blocks,
stage s's params on `devices[s]`: the JAX package's `shard_map` pipeline,
whose `collective_permute` between stages becomes a copy to the next
stage's device.  `two_stage_schedule` is the same schedule for two stages
at the host level: a producer thread runs stage A over the items while the
caller's thread runs stage B, with a bounded hand-off queue between them
(the PipelinedExecutor of core/accelerator.py uses it).

Numerics match the single-device stack exactly: only the execution order
changes.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Sequence

import torch

from repro_torch.core.device import resolve_device

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


def _stage_slice(tree, s: int, device: torch.device):
    """Stage s's slice of a tree (tensor, dict, list or tuple) whose leaves have
    the stage on their leading dim, as tensors on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree[s].to(device)
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s, device) for v in tree)
    raise TypeError(f"params leaves must be tensors, got {type(tree).__name__}")


def pipeline_forward(devices, stage_fn: Callable, params_stacked, x: torch.Tensor) -> torch.Tensor:
    """Run x through len(devices) sequential blocks, block s on devices[s] (GPipe).

    stage_fn(stage_params, x, stage_idx) -> x.  params_stacked: a tensor,
    or a dict/list/tuple tree of tensors, each with a leading dim of
    n_stages; stage s's slice is copied to devices[s] and lives there.
    x: (n_micro, mb, ...) microbatches; the output has the same layout, on
    x's device.

    The standard fill-drain schedule over n_micro + n_stages - 1 ticks: at
    tick t stage s runs microbatch t - s (when there is one), and its
    output moves one stage on, to the next stage's device, for tick t + 1.
    One thread enqueues every tick; the work of different cards overlaps
    because each launch and peer copy is asynchronous, and a peer copy is
    ordered after the source stage's work and before the destination's
    next work (PyTorch orders a copy across cards on both cards' current
    streams).  A device may be named more than once: its stages then run
    one after another on it.
    """
    devices = tuple(resolve_device(d) for d in devices)
    n_stages, n_micro = len(devices), x.shape[0]
    if n_stages < 1:
        raise ValueError("pipeline_forward needs at least one stage device")
    params = [_stage_slice(params_stacked, s, devices[s]) for s in range(n_stages)]
    inbox: list = [None] * n_stages  # the activation each stage takes at this tick
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # last stage first, so each stage consumes its input before the
        # stage behind it hands over the next one
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            inp = x[m].to(devices[0]) if s == 0 else inbox[s]
            y = stage_fn(params[s], inp, s)
            if s == n_stages - 1:
                outs[m] = y.to(x.device)
            else:
                inbox[s + 1] = y.to(devices[s + 1])
    return torch.stack(outs)
