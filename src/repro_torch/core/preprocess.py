"""The preprocessing result shared by the engine and the model."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.query import NeighborSet


class PreprocessResult(NamedTuple):
    """Sampled centroids and their neighbour sets for one SA stage.

    Fields lead with the batch dim when the engine ran on a batch.
    centroid_idx: (M,) int32 global indices into the input cloud.
    centroid_xyz: (M, 3).
    neighbors: idx (M, nsample) int32 global; mask (M, nsample).
    centroid_valid: (M,) bool, False for centroids from padded tile slots.
    """

    centroid_idx: torch.Tensor
    centroid_xyz: torch.Tensor
    neighbors: NeighborSet
    centroid_valid: torch.Tensor
