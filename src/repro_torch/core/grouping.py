"""Grouping / aggregation — standard, and delayed (paper C5, from Mesorasi [8]).

Standard PointNet++ set abstraction groups first: each centroid's
neighbours (M, nsample, C) go through the MLP, then a max-pool, so MLP cost
scales with M * nsample.  Delayed aggregation runs the MLP per *point* and
only then gathers each centroid's neighbours and max-pools them, so MLP
cost scales with N; that gather and max-pool are one op
(`kernels/group_pool`: a kernel on the card, `masked_maxpool` of
`group_features` on the CPU).  `interpolate_features` is the segmentation
model's up-sampling: 3-NN inverse-distance interpolation of coarse features.
"""

from __future__ import annotations

import torch

from repro_torch.core.query import NeighborSet
from repro_torch.kernels.group_pool import ops as group_pool

_NEG = -1e30


def group_features(features: torch.Tensor, nbrs: NeighborSet) -> torch.Tensor:
    """Gather neighbour features: (..., N, C), idx (..., M, S) -> (..., M, S, C)."""
    idx = nbrs.idx.long()
    lead, (m, s) = idx.shape[:-2], idx.shape[-2:]
    flat = idx.reshape(*lead, m * s, 1)
    return torch.take_along_dim(features, flat, dim=-2).reshape(*lead, m, s, features.shape[-1])


def group_relative_coords(xyz: torch.Tensor, centroids_xyz: torch.Tensor,
                          nbrs: NeighborSet) -> torch.Tensor:
    """Neighbour coords relative to their centroid: (..., N, 3), (..., M, 3) -> (..., M, S, 3)."""
    return group_features(xyz, nbrs) - centroids_xyz[..., :, None, :]


def masked_maxpool(grouped: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the nsample axis, ignoring padded slots.  (..., M, S, C) -> (..., M, C).

    Centroids with no neighbour get 0 features.
    """
    # made on the device (a fill, no host copy), so a CUDA graph can capture it
    neg = torch.full((), _NEG, dtype=grouped.dtype, device=grouped.device)
    out = torch.where(mask[..., None], grouped, neg).amax(dim=-2)
    any_valid = mask.any(dim=-1)[..., None]
    return torch.where(any_valid, out, torch.zeros_like(out))


def aggregate_standard(features: torch.Tensor, nbrs: NeighborSet, mlp_fn) -> torch.Tensor:
    """group -> mlp -> pool (the un-delayed baseline): (..., N, C) -> (..., M, C')."""
    return masked_maxpool(mlp_fn(group_features(features, nbrs)), nbrs.mask)


def aggregate_delayed(features: torch.Tensor, nbrs: NeighborSet, mlp_fn,
                      backend: str | None = "auto") -> torch.Tensor:
    """mlp -> group -> pool (paper C5): (..., N, C) -> (..., M, C').

    The group and the pool are `group_maxpool`, which equals
    `masked_maxpool(group_features(...))` bit for bit and never builds the
    grouped tensor on the card.
    """
    return group_pool.group_maxpool(mlp_fn(features), nbrs.idx, nbrs.mask, backend=backend)


def interpolate_features(features: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """k-NN inverse-distance interpolation (FP layer up-sampling).

    features (..., N, C) at the coarse level; idx, weights (..., M, k) ->
    (..., M, C) = sum over j of features[idx[..., j]] * weights[..., j],
    added in index order j = 0, 1, ... like the reference's sum over k.
    """
    idx = idx.long()
    out = None
    for j in range(idx.shape[-1]):
        rows = torch.take_along_dim(features, idx[..., j:j + 1], dim=-2)  # (..., M, C)
        term = rows * weights[..., j:j + 1]
        out = term if out is None else out + term
    return out
