"""Point distances used by FPS and the neighbour queries (paper C1).

Distances:
  * metric="l2" : squared Euclidean (no sqrt — monotone, what baselines use)
  * metric="l1" : Manhattan (paper C1)

The three coordinate terms are summed as (x + y) + z, written out rather
than left to a reduction, so the plain versions, the CUDA kernels and the
JAX reference add in the same order and agree to the bit.
"""

from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["l1", "l2"]


def coord_sum(terms: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): (t0 + t1) + t2, in that order."""
    return (terms[..., 0] + terms[..., 1]) + terms[..., 2]


def point_distance(diff: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """Distance for coordinate differences: (..., 3) -> (...)."""
    if metric == "l1":
        return coord_sum(diff.abs())
    if metric == "l2":
        return coord_sum(diff * diff)
    raise ValueError(f"metric must be 'l1' or 'l2', got {metric!r}")


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """Distance matrix between point sets.  a: (..., N, 3), b: (..., M, 3) -> (..., N, M).

    L2 returns the *squared* distance; L1 the Manhattan distance (paper eq. 2).
    Leading dims broadcast, so a batch of tiles works unchanged.
    """
    return point_distance(a[..., :, None, :] - b[..., None, :, :], metric)
