"""Neighbour queries — lattice query (paper C1).

Lattice query (PC2IM): for each centroid, the *first* `nsample` points (in
index order) with L1 distance <= L = 1.6 * R, padded with the first hit (the
PointNet++ convention), plus a mask of the real neighbours.

The threshold is the Python double `range_factor * radius` rounded once to
float32, as in the reference, where it meets float32 distances.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fps import pairwise_distance

LATTICE_RANGE_FACTOR = 1.6  # paper: L = 1.6 * R


class NeighborSet(NamedTuple):
    """Neighbour indices and the mask of real (in-range) neighbours.

    idx: (..., M, nsample) int32 indices into the point set.
    mask: (..., M, nsample) bool.
    """

    idx: torch.Tensor
    mask: torch.Tensor


def _first_k_in_range(
    d: torch.Tensor, thresh: float, nsample: int, valid: torch.Tensor | None
) -> NeighborSet:
    """First-k selection per row of a distance matrix d: (..., M, N)."""
    limit = torch.tensor(np.float32(thresh), device=d.device)
    hit = d <= limit
    if valid is not None:
        hit = hit & valid[..., None, :]
    # slot of each hit = number of earlier hits in its row
    slot = torch.cumsum(hit, dim=-1) - 1
    slot_ok = hit & (slot < nsample)
    cols = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device).expand(d.shape)
    # hits past the last slot are written to one spare column, then dropped
    dest = torch.where(slot_ok, slot, nsample)
    out = torch.zeros(d.shape[:-1] + (nsample + 1,), dtype=torch.int32, device=d.device)
    out.scatter_(-1, dest, cols)
    out = out[..., :nsample]
    # slots fill in order, so slot s is real iff the row has more than s hits
    count = hit.sum(dim=-1, keepdim=True)
    msk = torch.arange(nsample, device=d.device) < count
    # empty slots take the first hit; a row with no hit keeps index 0
    out = torch.where(msk, out, out[..., :1])
    return NeighborSet(idx=out, mask=msk)


def lattice_query(
    points: torch.Tensor,
    centroids: torch.Tensor,
    radius: float,
    nsample: int,
    *,
    range_factor: float = LATTICE_RANGE_FACTOR,
    valid: torch.Tensor | None = None,
) -> NeighborSet:
    """PC2IM lattice query: L1 metric, range L = range_factor * radius (C1).

    points (..., N, 3), centroids (..., M, 3) -> idx/mask (..., M, nsample).
    """
    d = pairwise_distance(centroids, points, "l1")
    return _first_k_in_range(d, range_factor * radius, nsample, valid)
