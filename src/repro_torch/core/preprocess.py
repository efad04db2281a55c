"""Preprocessing pipelines, one cloud at a time: baseline-1, baseline-2 (TiPU-like), PC2IM.

All three produce the same interface — sampled centroids + neighbour sets —
so the PointNet2 model can swap them (`preproc="pc2im"` etc.):

  baseline1 : global exact-L2 FPS over the full cloud + global ball query.
  baseline2 : fixed-shape spatial grid tiles (padded, ragged occupancy) +
              local exact-L2 FPS + local ball query.            [TiPU 10]
  pc2im     : median partition (equal tiles) + local *L1* FPS +
              local lattice query (L = 1.6R).                   [this paper]

These are the semantic oracles, plain torch ops on one (N, 3) cloud; the
batched `core.engine.PreprocessEngine` must equal stacking them.  The tiled
flow (`_tiled_common`) also takes a batch of partitions, which is how the
engine runs baseline-2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import fps as fps_mod
from repro_torch.core import partition as part_mod
from repro_torch.core import query as query_mod
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


def preprocess_baseline1(points: torch.Tensor, n_centroids: int, radius: float,
                         nsample: int) -> PreprocessResult:
    """Global L2 FPS + global ball query (the costly canonical flow).  points: (N, 3)."""
    cidx = fps_mod.fps(points, n_centroids, metric="l2")
    cxyz = points[cidx.long()]
    nbrs = query_mod.ball_query(points, cxyz, radius, nsample)
    return PreprocessResult(cidx, cxyz, nbrs,
                            torch.ones((n_centroids,), dtype=torch.bool, device=points.device))


def _tiled_common(points: torch.Tensor, part: part_mod.Partition, n_centroids: int,
                  radius: float, nsample: int, metric: str, query: str) -> PreprocessResult:
    """Shared tiled flow: local FPS per tile + local neighbour query per tile.

    points (..., N, 3) with a partition of matching leading dims (tiles
    (..., T, P)).  Padded slots (valid False) are never sampled while a
    tile has a real point, and never appear as a neighbour; a centroid is
    real iff its tile slot was.
    """
    t, p = part.tiles.shape[-2:]
    if n_centroids % t != 0:
        raise ValueError(f"n_centroids={n_centroids} not divisible by n_tiles={t}")
    k = n_centroids // t
    lead = points.shape[:-2]

    coords = part_mod.partition_coords(points, part)  # (..., T, P, 3)
    local_c = fps_mod.fps_batched(coords, k, metric=metric, valid=part.valid).long()  # (..., T, k)
    cidx = torch.take_along_dim(part.tiles, local_c, dim=-1)  # global (..., T, k)
    cxyz = torch.take_along_dim(coords, local_c[..., None], dim=-2)  # (..., T, k, 3)
    cvalid = torch.take_along_dim(part.valid, local_c, dim=-1)

    qfn = query_mod.lattice_query if query == "lattice" else query_mod.ball_query
    nbrs = qfn(coords, cxyz, radius, nsample, valid=part.valid)  # idx (..., T, k, S) local
    # local tile slots -> global point indices
    nidx = torch.take_along_dim(part.tiles[..., None, :], nbrs.idx.long(), dim=-1)
    m = t * k
    return PreprocessResult(
        centroid_idx=cidx.reshape(*lead, m).to(torch.int32),
        centroid_xyz=cxyz.reshape(*lead, m, 3),
        neighbors=NeighborSet(
            idx=nidx.reshape(*lead, m, nsample).to(torch.int32),
            mask=(nbrs.mask & cvalid[..., None]).reshape(*lead, m, nsample),
        ),
        centroid_valid=cvalid.reshape(*lead, m),
    )


def grid_capacity(n_points: int, grid: int, capacity: int | None = None) -> int:
    """Baseline-2's tile capacity: `capacity`, else max(N // grid^3 * 2, 32) (2x mean, TiPU-style)."""
    return capacity if capacity is not None else max(n_points // (grid**3) * 2, 32)


def preprocess_baseline2(points: torch.Tensor, n_centroids: int, radius: float, nsample: int,
                         *, grid: int = 2, capacity: int | None = None) -> PreprocessResult:
    """TiPU-like: fixed spatial grid tiles (ragged -> padded) + local L2 FPS + ball query.

    points (N, 3), or a batch (B, N, 3) whose clouds are partitioned each
    on its own (the engine's form).
    """
    cap = grid_capacity(points.shape[-2], grid, capacity)
    part = part_mod.grid_partition(points, grid, cap)
    return _tiled_common(points, part, n_centroids, radius, nsample, "l2", "ball")


def preprocess_pc2im(points: torch.Tensor, n_centroids: int, radius: float, nsample: int,
                     *, depth: int = 3, axis_mode: str = "widest") -> PreprocessResult:
    """PC2IM: MSP equal tiles + local L1 FPS + local lattice query (C1+C2+C3).  points: (N, 3)."""
    part = part_mod.median_partition(points, depth, axis_mode=axis_mode)
    return _tiled_common(points, part, n_centroids, radius, nsample, "l1", "lattice")


PIPELINES = {
    "baseline1": preprocess_baseline1,
    "baseline2": preprocess_baseline2,
    "pc2im": preprocess_pc2im,
}
