"""The replica axis: which shard of which replica group this thread runs.

The JAX package binds the axis by mapping a computation over a 1-D mesh
(`shard_map`), and model code asks whether it is bound.  The port runs one
worker thread a shard (`launch.mesh.ReplicaMesh.run`), and each of them
binds the axis thread-locally around the shard's body: the call's
`ReplicaGroup` and the shard's index in it.  Model code keeps one body
and reaches the group only through the functions below, which stand where
the reference calls `jax.lax.axis_index`, `pmax` and `all_gather`.

Outside a bound axis (the single-device entry points, any other thread)
`replica_axis_active()` is False and every sharded code path is off, so one
policy object runs the same single-device math everywhere else, as in the
reference.  The LM's activation hints (`activation_sharding`,
`hint_residual`, `hint_batch_only`) come with the LM substrate.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# The one axis a serving replica's device group is laid out over.  Model
# code never names a group: `nn.Linear` and `quantize_symmetric` take the
# axis by this name, as in the reference.
REPLICA_AXIS = "shard"

# (group, index) of the shard the current context runs, None outside one.  A
# context variable, like `core.graphs.eager`'s: every thread starts in a
# fresh context, so a binding never leaks into another thread.
_FRAME: contextvars.ContextVar = contextvars.ContextVar("repro_torch_replica_axis",
                                                        default=None)


@contextlib.contextmanager
def replica_axis(group, index: int):
    """Bind REPLICA_AXIS on this thread to shard `index` of `group` inside the block.

    `group` is one call's `launch.mesh.ReplicaGroup`.  Nests; the previous
    binding comes back on exit.
    """
    token = _FRAME.set((group, index))
    try:
        yield
    finally:
        _FRAME.reset(token)


def replica_axis_active() -> bool:
    """True iff this thread runs a shard of a replica group (REPLICA_AXIS is bound)."""
    return _FRAME.get() is not None


def axis_frame(axis_name: str = REPLICA_AXIS) -> tuple:
    """(group, index) of the shard this thread runs.

    Raises NameError where the axis is unbound, as `jax.core.axis_frame`
    does for an unbound axis name.
    """
    frame = _FRAME.get()
    if axis_name != REPLICA_AXIS or frame is None:
        raise NameError(f"unbound axis name: {axis_name}")
    return frame


def axis_size(axis_name: str = REPLICA_AXIS) -> int:
    """Number of shards in the bound group."""
    return axis_frame(axis_name)[0].size


def axis_index(axis_name: str = REPLICA_AXIS) -> int:
    """This thread's shard index in the bound group (`jax.lax.axis_index`)."""
    return axis_frame(axis_name)[1]


def all_max(x: torch.Tensor, axis_name: str = REPLICA_AXIS) -> torch.Tensor:
    """Elementwise max of `x` over every shard of the group (`jax.lax.pmax`).

    Exact: every shard gets the same bits, on its own device.
    """
    group, index = axis_frame(axis_name)
    return group.all_max(index, x)


def all_gather(x: torch.Tensor, dim: int, axis_name: str = REPLICA_AXIS) -> torch.Tensor:
    """Every shard's `x` concatenated along `dim` in shard order, on this shard's device.

    The tiled `jax.lax.all_gather`.
    """
    group, index = axis_frame(axis_name)
    return group.all_gather(index, x, dim)
