"""Spatial partitioning (paper C2) — median splits (MSP) and the baselines.

MSP recursively splits the point set at the median along an axis, giving
2^depth tiles of exactly equal cardinality.  Equal cardinality is what lets
the engine fold (batch, tiles) into one kernel grid with no padding.

Baselines for the utilisation/energy comparison:
  * morton_partition — Morton(Z)-order sort + equal-count chunks ([11][12]).
  * grid_partition   — fixed-shape spatial grid tiles (TiPU [10]): ragged
    occupancy, padded to a fixed capacity -> wasted slots (`valid` False).

Every function works on one cloud (N, 3) or a batch (B, N, 3); each cloud
is partitioned on its own, exactly as the JAX reference's per-cloud
function under vmap.  They are plain torch ops on every device, with no
read-back to the host, so a CUDA graph can capture them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Partition(NamedTuple):
    """tiles: (..., n_tiles, tile_size) int64 indices into the point array.

    valid: same shape bool — always True for MSP.
    """

    tiles: torch.Tensor
    valid: torch.Tensor

    @property
    def n_tiles(self) -> int:
        """Tiles per cloud."""
        return self.tiles.shape[-2]

    @property
    def tile_size(self) -> int:
        """Slots per tile (the capacity, for a grid partition)."""
        return self.tiles.shape[-1]

    def utilization(self) -> torch.Tensor:
        """Share of real (valid) slots, over every tile (and cloud): a 0-d float32."""
        return self.valid.to(torch.float32).mean()


def _gather_points(points: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3), tiles (B, t, p) -> coords (B, t, p, 3)."""
    b, t, p = tiles.shape
    flat = torch.take_along_dim(points, tiles.reshape(b, t * p, 1), dim=1)
    return flat.reshape(b, t, p, 3)


def _split_axis(points: torch.Tensor, tiles: torch.Tensor, mode: str, level: int) -> torch.Tensor:
    """Split axis per tile: cycle x/y/z, or the widest extent (first on ties).

    points (B, N, 3), tiles (B, t, p) -> (B, t) int64.
    """
    b, t, _ = tiles.shape
    if mode == "cycle":
        return torch.full((b, t), level % 3, dtype=torch.int64, device=points.device)
    if mode != "widest":
        raise ValueError(f"axis_mode must be 'widest' or 'cycle', got {mode!r}")
    coords = _gather_points(points, tiles)
    extent = coords.amax(dim=2) - coords.amin(dim=2)  # (B, t, 3)
    return torch.argmax(extent, dim=-1)  # first index of the max, like jnp.argmax


def median_partition(points: torch.Tensor, depth: int, *, axis_mode: str = "widest") -> Partition:
    """MSP: recursively median-split into 2^depth equal-size tiles.

    points: (N, 3) or (B, N, 3) with N divisible by 2^depth.  At each level
    every tile's indices are sorted by the chosen axis coordinate and the
    tile is cut in half.  The sort is stable, as jnp.argsort's is: snapped
    clouds have many equal coordinates, and an unstable sort would order
    them differently from the reference.
    """
    single = points.ndim == 2
    pts = points[None] if single else points
    b, n, _ = pts.shape
    if n % (1 << depth) != 0:
        raise ValueError(f"N={n} not divisible by 2^{depth}; pad first")

    tiles = torch.arange(n, device=pts.device).expand(b, 1, n)
    for level in range(depth):
        _, t, p = tiles.shape
        axes = _split_axis(pts, tiles, axis_mode, level)  # (B, t)
        coords = _gather_points(pts, tiles)  # (B, t, p, 3)
        key = torch.take_along_dim(coords, axes[:, :, None, None], dim=3)[..., 0]
        order = torch.argsort(key, dim=-1, stable=True)
        tiles = torch.take_along_dim(tiles, order, dim=-1).reshape(b, t * 2, p // 2)
    if single:
        tiles = tiles[0]
    return Partition(tiles=tiles, valid=torch.ones_like(tiles, dtype=torch.bool))


def pad_points(points: torch.Tensor, multiple: int) -> tuple:
    """Pad N to a multiple by repeating the last point: (..., N, 3) -> (points, valid (..., N'))."""
    n = points.shape[-2]
    pad = (-n) % multiple
    lead = points.shape[:-2]
    valid = torch.ones((*lead, n + pad), dtype=torch.bool, device=points.device)
    if pad == 0:
        return points, valid
    filler = points[..., -1:, :].expand(*lead, pad, points.shape[-1])
    valid[..., n:] = False
    return torch.cat([points, filler], dim=-2), valid


def _unit_cells(points: torch.Tensor, levels: int) -> torch.Tensor:
    """((p - lo) / max(hi - lo, 1e-12)) * levels per axis, in that order, lo/hi per cloud."""
    lo = points.amin(dim=-2, keepdim=True)
    hi = points.amax(dim=-2, keepdim=True)
    return (points - lo) / torch.clamp(hi - lo, min=1e-12) * levels


def morton_codes(points: torch.Tensor, bits_per_axis: int = 10) -> torch.Tensor:
    """Interleave quantized coordinate bits into a Morton (Z-order) code: (..., N, 3) -> (..., N).

    int64 (torch's uint32 has no shifts); the codes are below 2^(3 bits),
    2^30 by default, so they equal the reference's uint32 codes.
    """
    levels = (1 << bits_per_axis) - 1
    q = torch.clamp(torch.round(_unit_cells(points, levels)), 0, levels).to(torch.int64)
    code = torch.zeros(points.shape[:-1], dtype=torch.int64, device=points.device)
    for b in range(bits_per_axis):
        for a in range(3):
            code = code | (((q[..., a] >> b) & 1) << (3 * b + a))
    return code


def morton_partition(points: torch.Tensor, depth: int) -> Partition:
    """Morton-sort then chop into 2^depth equal-count chunks ([11][12] style).

    points (N, 3) or (B, N, 3), N divisible by 2^depth.  The sort is
    stable, as jnp.argsort's is.
    """
    n = points.shape[-2]
    if n % (1 << depth) != 0:
        raise ValueError(f"N={n} not divisible by 2^{depth}; pad first")
    order = torch.argsort(morton_codes(points), dim=-1, stable=True)
    tiles = order.reshape(*points.shape[:-2], 1 << depth, n >> depth)
    return Partition(tiles=tiles, valid=torch.ones_like(tiles, dtype=torch.bool))


def grid_partition(points: torch.Tensor, grid: int, capacity: int) -> Partition:
    """Fixed-shape spatial tiles (TiPU [10]): grid^3 cells, each padded to `capacity`.

    points (N, 3) or (B, N, 3) -> tiles/valid (..., grid^3, capacity).  A
    cell keeps its points in index order (a stable sort by cell id, then
    the rank within the cell); points past `capacity` are dropped, and the
    empty slots hold index 0 with `valid` False.  The scatter writes the
    dropped points to one spare slot, sliced off afterwards, so nothing is
    read back to the host.
    """
    n = points.shape[-2]
    lead = points.shape[:-2]
    cell = torch.clamp(torch.floor(_unit_cells(points, grid)), 0, grid - 1).to(torch.int64)
    tile_id = cell[..., 0] * grid * grid + cell[..., 1] * grid + cell[..., 2]  # (..., N)
    n_tiles = grid**3

    order = torch.argsort(tile_id, dim=-1, stable=True)
    sorted_tid = torch.take_along_dim(tile_id, order, dim=-1).contiguous()
    cells = torch.arange(n_tiles, device=points.device).expand(*lead, n_tiles).contiguous()
    first = torch.searchsorted(sorted_tid, cells, side="left")  # (..., n_tiles)
    rank = torch.arange(n, device=points.device) - torch.take_along_dim(first, sorted_tid, dim=-1)

    keep = rank < capacity
    spare = n_tiles * capacity
    dest = torch.where(keep, sorted_tid * capacity + rank, spare)
    tiles = torch.zeros((*lead, spare + 1), dtype=torch.int64, device=points.device)
    valid = torch.zeros((*lead, spare + 1), dtype=torch.bool, device=points.device)
    tiles.scatter_(-1, dest, order)
    valid.scatter_(-1, dest, keep)
    shape = (*lead, n_tiles, capacity)
    return Partition(tiles=tiles[..., :spare].reshape(shape),
                     valid=valid[..., :spare].reshape(shape))


def partition_coords(points: torch.Tensor, part: Partition) -> torch.Tensor:
    """Gather tiled coordinates: points (..., N, 3) -> (..., n_tiles, tile_size, 3)."""
    lead = part.tiles.shape[:-2]
    t, p = part.tiles.shape[-2:]
    flat = torch.take_along_dim(points, part.tiles.reshape(*lead, t * p, 1), dim=-2)
    return flat.reshape(*lead, t, p, 3)
