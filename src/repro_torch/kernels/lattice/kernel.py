"""Launch wrappers of the lattice query kernel (`csrc/lattice.cu`): per tile and flat."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, registry


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("lattice").pc2im_lattice_tiles
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(
    coords: torch.Tensor, centroids: torch.Tensor, nsample: int, l_range: float, name: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (T, P, 3) / (T, K, 3) tensors, counting it as `name`.

    Nothing is launched (or counted) when there is no centroid.
    """
    t, p, three = coords.shape
    if three != 3 or centroids.shape[0] != t or centroids.shape[2] != 3:
        raise ValueError(
            f"expected coords (T, P, 3) and centroids (T, K, 3), got "
            f"{tuple(coords.shape)} and {tuple(centroids.shape)}"
        )
    if centroids.device != coords.device:
        raise ValueError("coords and centroids must lie on the same device")
    if nsample < 1:
        raise ValueError(f"nsample={nsample} must be >= 1")
    kk = centroids.shape[1]
    idx = torch.empty((t, kk, nsample), dtype=torch.int32, device=coords.device)
    mask = torch.empty((t, kk, nsample), dtype=torch.bool, device=coords.device)
    if t == 0 or kk == 0:
        return idx, mask
    if p == 0:
        raise ValueError("tiles must hold at least one point")
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    status = _entry()(
        coords.device.index, coords.data_ptr(), centroids.data_ptr(),
        idx.data_ptr(), mask.data_ptr(), t, kk, p, nsample,
        ctypes.c_float(np.float32(l_range)), stream,
    )
    build.check(status, "lattice")
    registry.count_launch(name)
    return idx, mask


def lattice_tiles_cuda(
    coords: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """coords (T, P, 3), centroids (T, K, 3) float32 CUDA -> idx int32, mask bool.

    One warp per centroid, launched on the current stream.  `l_range` is
    rounded to float32 once, here, as the reference compares it.
    """
    registry.require_cuda_tensor(coords, "coords", torch.float32, 3)
    registry.require_cuda_tensor(centroids, "centroids", torch.float32, 3)
    return _launch(coords, centroids, nsample, l_range, "lattice_tiles")


def lattice_query_cuda(
    points: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """points (P, 3), centroids (M, 3) float32 CUDA -> idx (M, nsample) int32, mask bool.

    The flat query: the same kernel over one set, launched as one tile
    holding all M centroids and all P points.
    """
    registry.require_cuda_tensor(points, "points", torch.float32, 2)
    registry.require_cuda_tensor(centroids, "centroids", torch.float32, 2)
    idx, mask = _launch(points[None], centroids[None], nsample, l_range, "lattice_query")
    return idx[0], mask[0]
