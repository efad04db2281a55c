"""Batched PreprocessEngine — end-to-end (B, N, 3) preprocessing, one launch a kernel.

A `PreprocessEngine` is built once from an `EngineConfig` and maps a whole
batch of clouds to a batched `PreprocessResult`:

    engine = PreprocessEngine(EngineConfig(pipeline="pc2im", n_centroids=128,
                                           radius=0.3, nsample=16, depth=3))
    res = engine(points)          # points (B, N, 3) -> fields lead with B

The key dataflow move: batch and MSP tiles are FOLDED INTO ONE TILE AXIS.
After partitioning, the B clouds' 2^depth tiles become one (B·T, P, 3)
tensor, and the FPS and lattice kernels each launch once for the whole
batch (the paper's C2 equal-size tiles extended to the batch dim).

Only the pc2im pipeline (MSP + L1 FPS + lattice query) is ported so far;
the engine runs wherever its input lies: kernels for CUDA tensors, plain
versions for CPU tensors (kernels/registry).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import torch

from repro_torch.core import partition as part_mod
from repro_torch.core.preprocess import PreprocessResult
from repro_torch.core.query import NeighborSet
from repro_torch.kernels.fps.ops import fps_tiles
from repro_torch.kernels.lattice.ops import lattice_query_tiles

Pipeline = Literal["pc2im"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static description of one preprocessing pipeline instance.

    metric/query default to the pipeline's canonical choice (pc2im: L1 FPS
    and the lattice query).
    """

    pipeline: Pipeline = "pc2im"
    n_centroids: int = 128
    radius: float = 0.3
    nsample: int = 16
    depth: int = 3  # MSP: tiles = 2^depth
    axis_mode: str = "widest"
    metric: str | None = None  # None -> pipeline default
    query: str | None = None  # None -> pipeline default
    backend: str | None = "auto"  # "auto" | "pallas" | "xla" (kernels/registry)

    @property
    def resolved_metric(self) -> str:
        """FPS distance metric with the None placeholder resolved."""
        return self.metric if self.metric is not None else "l1"

    @property
    def resolved_query(self) -> str:
        """Neighbour-query kind with the None placeholder resolved."""
        return self.query if self.query is not None else "lattice"

    @property
    def n_tiles(self) -> int:
        """Tiles per cloud seen by the kernels."""
        return 1 << self.depth


def clamp_depth(n_points: int, n_centroids: int, depth: int) -> int:
    """Largest usable MSP depth <= `depth` for a given cloud/sample size.

    Keeps tiles no smaller than 4x the per-tile sample count and requires
    both N and n_centroids to split evenly (the MSP equal-tile property).
    """
    while depth > 0 and (n_points >> depth) < 4 * max(1, n_centroids >> depth):
        depth -= 1
    while depth > 0 and (n_points % (1 << depth) or n_centroids % (1 << depth)):
        depth -= 1
    return depth


class PreprocessEngine:
    """Batched preprocessing: (B, N, 3) -> PreprocessResult.

    Output fields lead with the batch dim: centroid_idx (B, M) int32,
    centroid_xyz (B, M, 3), neighbors.idx (B, M, nsample) int32 and .mask,
    centroid_valid (B, M), with M = n_centroids and indices global per cloud.
    A single (N, 3) cloud is accepted and returns unbatched fields.
    """

    def __init__(self, config: EngineConfig):
        if config.pipeline != "pc2im":
            raise ValueError(
                f"pipeline {config.pipeline!r} is not ported; this engine runs 'pc2im'"
            )
        if config.resolved_query != "lattice":
            raise ValueError(f"query {config.resolved_query!r} is not ported; use 'lattice'")
        if config.n_centroids % config.n_tiles:
            raise ValueError(
                f"n_centroids={config.n_centroids} not divisible by "
                f"2^depth={config.n_tiles} tiles"
            )
        self.config = config

    def __call__(self, points: torch.Tensor) -> PreprocessResult:
        """Run the pipeline on (B, N, 3) or single (N, 3) coordinates.

        See the class docstring for the output layout.
        """
        if points.ndim == 2:
            if points.shape[-1] != 3:
                raise ValueError(f"expected (B, N, 3) or (N, 3), got {tuple(points.shape)}")
            res = self(points[None])
            return PreprocessResult(
                res.centroid_idx[0], res.centroid_xyz[0],
                NeighborSet(res.neighbors.idx[0], res.neighbors.mask[0]),
                res.centroid_valid[0],
            )
        if points.ndim != 3 or points.shape[-1] != 3:
            raise ValueError(f"expected (B, N, 3) or (N, 3), got {tuple(points.shape)}")
        if points.shape[1] % self.config.n_tiles:
            raise ValueError(
                f"N={points.shape[1]} not divisible by 2^depth={self.config.n_tiles}; "
                f"pad the clouds or lower depth (see clamp_depth)"
            )
        return self._pc2im(points)

    def _pc2im(self, points: torch.Tensor) -> PreprocessResult:
        """MSP tiles + local FPS + local query; batch x tiles fold into one (B·T, P) launch."""
        cfg = self.config
        b, n, _ = points.shape
        t = cfg.n_tiles
        p = n // t
        k = cfg.n_centroids // t

        # per-cloud MSP (batched stable argsorts); tiles (B, T, P) global per cloud
        tiles = part_mod.median_partition(points, cfg.depth, axis_mode=cfg.axis_mode).tiles

        # FOLD: (B, T, P, 3) -> (B·T, P, 3); one kernel launch for all clouds
        flat_tiles = tiles.reshape(b * t, p)
        flat_coords = torch.take_along_dim(
            points, tiles.reshape(b, t * p, 1), dim=1
        ).reshape(b * t, p, 3)

        local_c = fps_tiles(
            flat_coords, k, metric=cfg.resolved_metric, backend=cfg.backend
        ).long()  # (B·T, k) local
        cidx = torch.take_along_dim(flat_tiles, local_c, dim=1)  # global
        cxyz = torch.take_along_dim(flat_coords, local_c[..., None], dim=1)

        nbrs_local = lattice_query_tiles(
            flat_coords, cxyz, cfg.radius, cfg.nsample, backend=cfg.backend
        )
        # local tile slots -> global point indices
        nidx = torch.take_along_dim(flat_tiles[:, None, :], nbrs_local.idx.long(), dim=2)

        m = t * k
        return PreprocessResult(
            centroid_idx=cidx.reshape(b, m).to(torch.int32),
            centroid_xyz=cxyz.reshape(b, m, 3),
            neighbors=NeighborSet(
                idx=nidx.reshape(b, m, cfg.nsample).to(torch.int32),
                mask=nbrs_local.mask.reshape(b, m, cfg.nsample),
            ),
            centroid_valid=torch.ones((b, m), dtype=torch.bool, device=points.device),
        )


@functools.lru_cache(maxsize=None)
def get_engine(config: EngineConfig) -> PreprocessEngine:
    """Engine cache: one engine per distinct config (models build one per SA stage)."""
    return PreprocessEngine(config)
