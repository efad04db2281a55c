"""Public op: tiled FPS dispatched through the kernel registry.

`fps_tiles(points_tiled, k)` takes MSP-layout tiles (T, P, 3).  The tile
axis is the kernel's grid axis: callers fold any batch dims into it (the
PreprocessEngine folds (B, T, P) -> (B·T, P) so B clouds launch once).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.fps.kernel import fps_tiles_cuda
from repro_torch.kernels.fps.ref import fps_tiles_plain

registry.register("fps_tiles", plain=fps_tiles_plain, cuda=fps_tiles_cuda)


def fps_tiles(
    points_tiled: torch.Tensor, k: int, *, metric: str = "l1", backend: str | None = "auto"
) -> torch.Tensor:
    """Batched per-tile FPS.  points_tiled: (T, P, 3) -> (T, k) int32 local indices.

    The kernel on a CUDA tensor, the plain version on a CPU tensor.
    """
    if points_tiled.ndim != 3 or points_tiled.shape[-1] != 3:
        raise ValueError(f"expected (T, P, 3) tiles, got {tuple(points_tiled.shape)}")
    impl = registry.dispatch("fps_tiles", points_tiled, backend)
    return impl(points_tiled.to(torch.float32).contiguous(), k, metric=metric)
