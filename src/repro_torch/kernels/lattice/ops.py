"""Public op: per-tile lattice query via the kernel registry."""

from __future__ import annotations

import torch

from repro_torch.core.query import LATTICE_RANGE_FACTOR, NeighborSet
from repro_torch.kernels import registry
from repro_torch.kernels.lattice.kernel import lattice_tiles_cuda
from repro_torch.kernels.lattice.ref import lattice_tiles_plain

registry.register("lattice_tiles", plain=lattice_tiles_plain, cuda=lattice_tiles_cuda)


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
