"""Median spatial partitioning (MSP, paper C2).

MSP recursively splits the point set at the median along an axis, giving
2^depth tiles of exactly equal cardinality.  Equal cardinality is what lets
the engine fold (batch, tiles) into one kernel grid with no padding.

Works on one cloud (N, 3) or a batch (B, N, 3); each cloud is split on its
own, exactly as the JAX reference's per-cloud function under vmap.
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
