"""PartitionSpec and NamedSharding: how a tensor's dims map onto a mesh's axes.

The port's stand-ins for `jax.sharding.PartitionSpec` and `NamedSharding`,
plain frozen data.  A spec holds one entry a leading dim of the tensor:
None (the dim is whole on every device), an axis name (the dim is split
over that mesh axis) or a tuple of axis names (split over their product,
the first axis the slowest).  Dims past the spec's length are whole.  As
in JAX, a one-name tuple is that name and an empty tuple is None, so
`PartitionSpec(("data",))` equals `PartitionSpec("data")`.

The mesh is any object with `shape` (an ordered mapping axis -> size) and
`axis_names`, such as `launch.mesh.Mesh`.  Nothing here moves data:
`NamedSharding.shard_shape` gives one device's block, padded as GSPMD pads
a dim that its axes do not divide (ceil division), and `place` copies a
tensor's block onto a mesh device.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One entry a leading dim: None, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> tuple[str, ...]:
        """The mesh axes that split dim `dim` (none past the spec's end)."""
        if dim >= len(self):
            return ()
        e = self[dim]
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec bound to a mesh (a `launch.mesh.Mesh`, compared by identity)."""

    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        if not isinstance(self.spec, PartitionSpec):
            object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        for dim in range(len(self.spec)):
            for a in self.spec.axes_of(dim):
                if a not in self.mesh.axis_names:
                    raise ValueError(f"{self.spec}: axis {a!r} is not one of "
                                     f"{self.mesh.axis_names}")

    def ways(self, dim: int) -> int:
        """Into how many blocks dim `dim` is split: the product of its axes' sizes."""
        return math.prod(self.mesh.shape[a] for a in self.spec.axes_of(dim))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One device's block of a tensor of `shape`: each split dim ceil-divided by
        its ways (the last block zero-padded where the ways do not divide it)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than shape {tuple(shape)} has dims")
        return tuple(-(-n // self.ways(d)) for d, n in enumerate(shape))

    def shard_nbytes(self, t: torch.Tensor) -> int:
        """Bytes of one device's block of `t` (padding included)."""
        return math.prod(self.shard_shape(t.shape)) * t.element_size()


def place(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """A new tensor on the mesh's device holding `t`'s block under `sharding`.

    Only a mesh of one device is placed: there the block is all of `t`, and
    the result is a copy of it.  Running one program over a mesh of several
    cards is not ported (the reference only compiles it: `launch/dryrun.py`).
    """
    mesh = sharding.mesh
    if mesh.devices is None:
        raise ValueError("an abstract mesh has no devices to place a tensor on")
    if len(mesh.devices) != 1:
        raise NotImplementedError(
            f"placing a tensor over {len(mesh.devices)} devices: only a one-device mesh runs")
    out = torch.empty(sharding.shard_shape(t.shape), dtype=t.dtype, device=mesh.devices[0])
    return out.copy_(t)
