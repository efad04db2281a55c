"""Public ops: lattice query, per tile and over one flat set, via the kernel registry."""

from __future__ import annotations

import torch

from repro_torch.core.query import LATTICE_RANGE_FACTOR, NeighborSet
from repro_torch.kernels import registry
from repro_torch.kernels.lattice.kernel import lattice_query_cuda, lattice_tiles_cuda
from repro_torch.kernels.lattice.ref import lattice_query_plain, lattice_tiles_plain

registry.register("lattice_tiles", plain=lattice_tiles_plain, cuda=lattice_tiles_cuda)
registry.register("lattice_query", plain=lattice_query_plain, cuda=lattice_query_cuda)


def lattice_query_fused(
    points: torch.Tensor,
    centroids: torch.Tensor,
    radius: float,
    nsample: int,
    *,
    range_factor: float = LATTICE_RANGE_FACTOR,
    backend: str | None = "auto",
) -> NeighborSet:
    """Flat lattice query over one point set: core.query.lattice_query's signature.

    points (P, 3), centroids (M, 3) -> NeighborSet with idx/mask (M, nsample):
    each centroid's first `nsample` points within L1 range
    range_factor * radius, in index order.  The kernel on CUDA tensors, the
    plain version on CPU tensors.
    """
    if points.ndim != 2 or points.shape[-1] != 3 or centroids.ndim != 2 or centroids.shape[-1] != 3:
        raise ValueError(
            f"expected points (P, 3) and centroids (M, 3), got "
            f"{tuple(points.shape)} and {tuple(centroids.shape)}"
        )
    l_range = float(radius * range_factor)
    impl = registry.dispatch("lattice_query", points, backend)
    idx, mask = impl(
        points.to(torch.float32).contiguous(), centroids.to(torch.float32).contiguous(),
        nsample=nsample, l_range=l_range,
    )
    return NeighborSet(idx=idx, mask=mask)


def lattice_query_tiles(
    coords: torch.Tensor,
    centroids: torch.Tensor,
    radius: float,
    nsample: int,
    *,
    range_factor: float = LATTICE_RANGE_FACTOR,
    backend: str | None = "auto",
) -> NeighborSet:
    """Per-tile lattice query: each tile's centroids against its own points.

    coords (T, P, 3), centroids (T, K, 3) -> NeighborSet with idx/mask
    (T, K, nsample), indices LOCAL to each tile.  One launch covers all T
    tiles — the PreprocessEngine folds (B, tiles) into T.
    """
    if coords.ndim != 3 or coords.shape[-1] != 3 or centroids.shape[0] != coords.shape[0]:
        raise ValueError(
            f"expected coords (T, P, 3) and centroids (T, K, 3), got "
            f"{tuple(coords.shape)} and {tuple(centroids.shape)}"
        )
    l_range = float(radius * range_factor)
    impl = registry.dispatch("lattice_tiles", coords, backend)
    idx, mask = impl(
        coords.to(torch.float32).contiguous(), centroids.to(torch.float32).contiguous(),
        nsample=nsample, l_range=l_range,
    )
    return NeighborSet(idx=idx, mask=mask)
