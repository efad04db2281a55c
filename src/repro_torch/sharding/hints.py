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
reference.

The LM's activation hints (Megatron-style sequence parallelism) come
below.  Models call `hint_residual(h)` at block boundaries, where the
reference constrains the residual stream (B, S, D) to a layout on the
mesh that `activation_sharding(mesh, mode=...)` made current: "sp" puts
the batch over the data axes and the sequence over "model", "fsdp2d" the
batch over every axis where it divides, "off" nothing.  The reference's
constraint changes no value, only where GSPMD places the activation; the
port runs one program on one device, so a hint returns its input itself
(the same tensor: the autograd graph is untouched), and `residual_spec` /
`batch_only_spec` give the spec the reference would impose, which the
dry run and the tests read.  Without an active context every hint is a
no-op.

The dry run's census (`launch.spmd`) runs a step once more with its tensors
laid out as DTensors; there a hint lays the residual stream out by its
spec or, where the reference sets none, by the batch alone
(`census_layout`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.sharding.spec import PartitionSpec

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


# -- the LM's activation hints ----------------------------------------------

# {"mesh", "daxes", "mode"} of the innermost `activation_sharding`, None outside one.
_HINTS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_activation_sharding",
                                                        default=None)


@contextlib.contextmanager
def activation_sharding(mesh, *, mode: str = "sp"):
    """Make `mesh` and `mode` the hints' layout inside the block.

    mode: "sp" (sequence parallel: batch over the data axes, sequence over
    "model"), "fsdp2d" (batch over every axis; falls back to "sp" where the
    batch does not divide) or "off".  The data axes are ("pod", "data") on
    a mesh with a "pod" axis, else ("data",).  Nests; the previous layout
    comes back on exit.
    """
    daxes = ("pod", "data") if "pod" in tuple(mesh.axis_names) else ("data",)
    token = _HINTS.set({"mesh": mesh, "daxes": daxes, "mode": mode})
    try:
        yield
    finally:
        _HINTS.reset(token)


def _data_ways(mesh, daxes) -> int:
    n = 1
    for a in daxes:
        n *= mesh.shape[a]
    return n


def residual_spec(shape, mesh, daxes: tuple, mode: str) -> PartitionSpec | None:
    """The spec the reference's `hint_residual` imposes on a tensor of `shape`
    (None: no constraint): the reference's rules, dim by dim."""
    if mode == "off" or len(shape) != 3:
        return None
    b, s, _ = shape
    dtotal = _data_ways(mesh, daxes)
    msize = mesh.shape["model"]
    if mode == "fsdp2d" and b % (dtotal * msize) == 0:
        return PartitionSpec(daxes + ("model",), None, None)
    # fsdp2d with a batch too small for both axes falls through to sp
    bspec = daxes if b % dtotal == 0 else None
    sspec = "model" if (s % msize == 0 and s >= msize) else None
    return PartitionSpec(bspec, sspec, None)


def batch_only_spec(shape, mesh, daxes: tuple) -> PartitionSpec | None:
    """The spec of the reference's `hint_batch_only` (None: no constraint): the
    leading dim over the data axes where they divide it."""
    if len(shape) < 1 or shape[0] % _data_ways(mesh, daxes):
        return None
    return PartitionSpec(daxes, *([None] * (len(shape) - 1)))


def _constrain(x: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """Where the reference calls `jax.lax.with_sharding_constraint(x,
    NamedSharding(mesh, spec))`: x itself.  The tests record (mesh, spec) here."""
    return x


# The dry run's census pass (`launch.spmd`), which lays the step's tensors out
# as DTensors, inside `census_layout`: its `constrain(x, mesh, daxes, spec)`
# lays x out by the spec, or where the reference imposes none (spec None)
# settles the residual stream.  None everywhere else.
_CENSUS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_census", default=None)


@contextlib.contextmanager
def census_layout(layout):
    """Make `layout` (the census's, `launch.spmd`) the one the hints ask inside the
    block; the previous one comes back on exit."""
    token = _CENSUS.set(layout)
    try:
        yield
    finally:
        _CENSUS.reset(token)


def _hint(x: torch.Tensor, c: dict, spec: PartitionSpec | None) -> torch.Tensor:
    census = _CENSUS.get()
    if census is not None:
        return census.constrain(x, c["mesh"], c["daxes"], spec)
    return x if spec is None else _constrain(x, c["mesh"], spec)


def hint_residual(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) residual-stream hint under the active layout; returns x itself."""
    c = _HINTS.get()
    if c is None:
        return x
    return _hint(x, c, residual_spec(tuple(x.shape), c["mesh"], c["daxes"], c["mode"]))


def hint_batch_only(x: torch.Tensor) -> torch.Tensor:
    """Hint only the leading batch dim (decode-path activations); returns x itself."""
    c = _HINTS.get()
    if c is None:
        return x
    return _hint(x, c, batch_only_spec(tuple(x.shape), c["mesh"], c["daxes"]))
