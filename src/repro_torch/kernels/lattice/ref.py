"""Plain PyTorch version of the per-tile lattice query kernel."""

from __future__ import annotations

import torch

from repro_torch.core.query import lattice_query


def lattice_tiles_plain(
    coords: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """coords (T, P, 3), centroids (T, K, 3) -> idx (T, K, nsample) int32, mask bool."""
    res = lattice_query(coords, centroids, l_range, nsample, range_factor=1.0)
    return res.idx, res.mask
