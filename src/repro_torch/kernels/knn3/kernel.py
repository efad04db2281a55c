"""Launch wrapper of the k-nearest-neighbour kernel (`csrc/knn3.cu`)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry

MAX_K = 8  # the kernel keeps its running top-k in registers, one instantiation per k


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("knn3").pc2im_knn3
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def knn3_cuda(
    queries: torch.Tensor, points: torch.Tensor, *, k: int = 3, metric: str = "l2"
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (B, Q, 3), points (B, P, 3) float32 CUDA -> idx (B, Q, k) int32, dist float32.

    One thread per query, one launch for all B clouds, on the current
    stream; nothing synchronises.
    """
    registry.require_cuda_tensor(queries, "queries", torch.float32, 3)
    registry.require_cuda_tensor(points, "points", torch.float32, 3)
    b, q, three = queries.shape
    if three != 3 or points.shape[0] != b or points.shape[2] != 3:
        raise ValueError(
            f"expected queries (B, Q, 3) and points (B, P, 3), got "
            f"{tuple(queries.shape)} and {tuple(points.shape)}"
        )
    if points.device != queries.device:
        raise ValueError("queries and points must lie on the same device")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    if metric not in ("l1", "l2"):
        raise ValueError(f"metric must be 'l1' or 'l2', got {metric!r}")
    p = points.shape[1]
    if p < k:
        raise ValueError(f"need at least k={k} points, got P={p}")
    idx = torch.empty((b, q, k), dtype=torch.int32, device=queries.device)
    dist = torch.empty((b, q, k), dtype=torch.float32, device=queries.device)
    if b == 0 or q == 0:
        return idx, dist
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    status = _entry()(
        queries.device.index, queries.data_ptr(), points.data_ptr(),
        idx.data_ptr(), dist.data_ptr(), b, q, p, k, int(metric == "l1"), stream,
    )
    build.check(status, "knn3")
    registry.count_launch("knn3")
    return idx, dist
