"""Plain PyTorch version of the FPS tile kernel."""

from __future__ import annotations

import torch

from repro_torch.core.fps import point_distance


def fps_tiles_plain(points: torch.Tensor, k: int, *, metric: str = "l1") -> torch.Tensor:
    """points: (T, P, 3) -> (T, k) int32 local indices.

    Starts at index 0 with dmin = 1e30; each step takes the first index of
    the largest dmin (torch.argmax returns the first maximal index), like
    the kernel and the JAX reference.
    """
    t, p, _ = points.shape
    rows = torch.arange(t, device=points.device)
    dmin = torch.full((t, p), 1e30, dtype=torch.float32, device=points.device)
    last = torch.zeros(t, dtype=torch.int64, device=points.device)
    out = torch.empty((t, k), dtype=torch.int32, device=points.device)
    for s in range(k):
        out[:, s] = last
        ref = points[rows, last]  # (T, 3)
        dmin = torch.minimum(dmin, point_distance(points - ref[:, None, :], metric))
        last = torch.argmax(dmin, dim=1)
    return out
