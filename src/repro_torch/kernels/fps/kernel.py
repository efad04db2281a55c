"""Launch wrapper of the FPS tile kernel (`csrc/fps.cu`)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry

MAX_TILE_POINTS = 8192  # 8 points a thread in a 1024-thread block


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("fps").pc2im_fps_tiles
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fps_tiles_cuda(points: torch.Tensor, k: int, *, metric: str = "l1") -> torch.Tensor:
    """points: (T, P, 3) float32 CUDA -> (T, k) int32 local indices.

    One warp per tile up to 1024 points (32 a lane), one block per tile
    beyond; launched on the current stream; nothing synchronises.
    """
    registry.require_cuda_tensor(points, "points", torch.float32, 3)
    t, p, three = points.shape
    if three != 3:
        raise ValueError(f"points must be (T, P, 3), got {tuple(points.shape)}")
    if not 1 <= p <= MAX_TILE_POINTS:
        raise ValueError(f"tile size P={p} must be in [1, {MAX_TILE_POINTS}]")
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if metric not in ("l1", "l2"):
        raise ValueError(f"metric must be 'l1' or 'l2', got {metric!r}")
    out = torch.empty((t, k), dtype=torch.int32, device=points.device)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(points.device).cuda_stream
    status = build.launch(
        _entry(), points.device, points.data_ptr(), out.data_ptr(),
        t, p, k, int(metric == "l1"), stream,
    )
    build.check(status, "fps")
    registry.count_launch("fps_tiles", stream)
    return out
