"""How a serving replica over a device group lays out its data: the replica specs.

Only the PC2IM serving part of the JAX package's `sharding/policy.py` is
here; the LM's parameter, batch and state specs come with the LM
substrate.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.sharding.hints import REPLICA_AXIS

REPLICA_SHARDING_MODES = ("batch", "tensor")


class ReplicaSpecs(NamedTuple):
    """Along which axis each of (params, points, logits) is split over a replica group.

    None means replicated: every shard holds all of it.  REPLICA_AXIS on a
    tensor means its leading (batch) dim is split in contiguous row blocks,
    shard i holding block i.
    """

    params: str | None
    points: str | None
    logits: str | None


def replica_specs(mode: str) -> ReplicaSpecs:
    """(params, points, logits) layout of one sharded replica under `mode`.

    The contract of the reference's `replica_specs`:

      * params are replicated: each device of the group holds a full copy;
      * the points' batch dim is split over the group in both modes.
        "batch" keeps it split end to end (each device runs the whole
        pipeline on its rows); "tensor" preprocesses the local rows, then
        gathers the neighbourhoods so that the feature MLPs can split every
        weight's columns over the group (the split-concatenate dataflow),
        inside the shard's body, so the boundary layout is the same;
      * the logits leave split by rows, and the caller reassembles the batch.

    Raises ValueError for a mode not in REPLICA_SHARDING_MODES.
    """
    if mode not in REPLICA_SHARDING_MODES:
        raise ValueError(
            f"sharding mode must be one of {REPLICA_SHARDING_MODES}, got {mode!r}"
        )
    return ReplicaSpecs(params=None, points=REPLICA_AXIS, logits=REPLICA_AXIS)
