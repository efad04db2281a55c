"""Plain PyTorch version of the k-nearest-neighbour kernel."""

from __future__ import annotations

import torch

from repro_torch.core.query import knn


def knn3_plain(
    queries: torch.Tensor, points: torch.Tensor, *, k: int = 3, metric: str = "l2"
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (B, Q, 3), points (B, P, 3) -> idx (B, Q, k) int32, dist (B, Q, k) float32."""
    return knn(queries, points, k, metric=metric)
