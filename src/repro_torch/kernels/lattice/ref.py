"""Plain PyTorch versions of the lattice query kernel: per tile and flat."""

from __future__ import annotations

import torch

from repro_torch.core.query import lattice_query


def lattice_tiles_plain(
    coords: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """coords (T, P, 3), centroids (T, K, 3) -> idx (T, K, nsample) int32, mask bool."""
    res = lattice_query(coords, centroids, l_range, nsample, range_factor=1.0)
    return res.idx, res.mask


def lattice_query_plain(
    points: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """points (P, 3), centroids (M, 3) -> idx (M, nsample) int32, mask bool."""
    res = lattice_query(points, centroids, l_range, nsample, range_factor=1.0)
    return res.idx, res.mask
