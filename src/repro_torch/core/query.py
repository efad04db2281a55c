"""Neighbour queries — ball query (baseline), lattice query (paper C1), kNN.

Ball query (PointNet++): for each centroid, the *first* `nsample` points
(in index order) with squared L2 distance <= R * R, padded with the first
hit (the PointNet++ convention), plus a mask of the real neighbours.

Lattice query (PC2IM): the same first-k selection under the L1 metric and
the adaptive range L = 1.6 * R.

Each threshold is a Python double (`radius * radius`, `range_factor *
radius`) rounded once to float32, as in the reference, where it meets
float32 distances.  The ball query is a plain torch op on every device (the
reference runs it in XLA on every backend); the lattice query's tile form
has a kernel (kernels/lattice).

kNN (the segmentation model's up-sampling): for each query, the k smallest
distances and their indices, as k rounds of first-index argmin and
mask-out, the dataflow of kernels/knn3.
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
    limit = torch.full((), float(np.float32(thresh)), dtype=torch.float32, device=d.device)
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


def ball_query(
    points: torch.Tensor,
    centroids: torch.Tensor,
    radius: float,
    nsample: int,
    *,
    valid: torch.Tensor | None = None,
) -> NeighborSet:
    """L2 ball query.  points (..., N, 3), centroids (..., M, 3) -> idx/mask (..., M, nsample).

    `valid` (..., N) keeps padded points out of every neighbour set.
    """
    d = pairwise_distance(centroids, points, "l2")  # squared
    return _first_k_in_range(d, radius * radius, nsample, valid)


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


def knn(query_xyz: torch.Tensor, ref_xyz: torch.Tensor, k: int,
        metric: str = "l2", *, valid: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query point among the reference points.

    query_xyz (..., M, 3), ref_xyz (..., N, 3) -> (idx (..., M, k) int32,
    dist (..., M, k)), dist squared for l2.  Each round takes the first index
    of the row minimum (torch.argmin returns the first) and masks it with
    inf, so ties go to the lower index: the first k of a stable sort by
    (distance, index).  `valid` (..., N) sets padded points' distances to
    inf before the first round.
    """
    d = pairwise_distance(query_xyz, ref_xyz, metric)  # (..., M, N)
    if valid is not None:
        d = torch.where(valid[..., None, :], d, torch.full((), float("inf"), device=d.device))
    idxs, dists = [], []
    for _ in range(k):
        j = torch.argmin(d, dim=-1, keepdim=True)
        dists.append(torch.take_along_dim(d, j, dim=-1))
        idxs.append(j)
        d = d.scatter(-1, j, float("inf"))
    return torch.cat(idxs, dim=-1).to(torch.int32), torch.cat(dists, dim=-1)


def neighbor_overlap(ref: NeighborSet, other: NeighborSet, n_points: int) -> tuple:
    """How many of `ref`'s real neighbours are also `other`'s, row by row (fig12a's recall).

    ref, other: idx/mask (..., M, S) over the same points (indices below
    n_points).  Returns (found, total), int64 (...): summed over the M rows,
    found counts ref's real neighbours that are among the same row's real
    neighbours of `other`, total counts ref's real neighbours.  Real slots
    hold distinct indices (first-k in index order), so these are set sizes.
    """
    lead = other.idx.shape[:-1]
    member = torch.zeros((*lead, n_points + 1), dtype=torch.bool, device=other.idx.device)
    member.scatter_(-1, torch.where(other.mask, other.idx.long(), n_points), True)
    hit = torch.take_along_dim(member, torch.where(ref.mask, ref.idx.long(), n_points), dim=-1)
    found = (hit & ref.mask).sum(dim=(-2, -1))
    return found, ref.mask.sum(dim=(-2, -1))


def three_nn_interpolate_weights(dist_sq: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights for 3-NN feature interpolation (FP layer).

    dist_sq (..., k) -> weights (..., k), normalised over the trailing axis.
    `eps` is a Python float added to the float32 distances, as in the
    reference, so a self-match (distance 0) weighs 1 / float32(1e-8).
    """
    w = 1.0 / (dist_sq + eps)
    return w / w.sum(dim=-1, keepdim=True)
