"""Public op: k nearest neighbours (the FP layers' 3-NN) via the kernel registry.

The batch axis is the kernel's grid axis, as the tile axis is for FPS and
the lattice query: B clouds' queries go out in one launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.knn3.kernel import knn3_cuda
from repro_torch.kernels.knn3.ref import knn3_plain

registry.register("knn3", plain=knn3_plain, cuda=knn3_cuda)


def knn3(
    queries: torch.Tensor,
    points: torch.Tensor,
    *,
    k: int = 3,
    metric: str = "l2",
    backend: str | None = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (B, Q, 3), points (B, P, 3) -> (idx (B, Q, k) int32, dist (B, Q, k) float32).

    Per query, the k smallest distances (squared for l2) among its cloud's
    points, ties to the lower index.  The kernel on CUDA tensors, the plain
    version on CPU tensors.
    """
    if (queries.ndim != 3 or points.ndim != 3 or queries.shape[-1] != 3
            or points.shape[-1] != 3 or queries.shape[0] != points.shape[0]):
        raise ValueError(
            f"expected queries (B, Q, 3) and points (B, P, 3), got "
            f"{tuple(queries.shape)} and {tuple(points.shape)}"
        )
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"k={k} must be in [1, P={points.shape[1]}]")
    impl = registry.dispatch("knn3", queries, backend)
    return impl(
        queries.to(torch.float32).contiguous(), points.to(torch.float32).contiguous(),
        k=k, metric=metric,
    )
