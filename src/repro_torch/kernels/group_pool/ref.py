"""Plain PyTorch version of the gather + masked max-pool kernel."""

from __future__ import annotations

import torch

from repro_torch.core.query import NeighborSet


def group_maxpool_plain(features: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, S) int32, mask (B, M, S) bool -> (B, M, C).

    The composition the kernel fuses: every slot's row gathered into the
    (B, M, S, C) grouped tensor, then the masked max over S (padded slots
    at -1e30, a centroid with no valid slot 0).
    """
    # imported here: core.grouping imports this kernel's op
    from repro_torch.core import grouping

    return grouping.masked_maxpool(grouping.group_features(features, NeighborSet(idx, mask)),
                                   mask)
