"""Launch wrapper of the gather + masked max-pool kernel (`csrc/group_pool.cu`)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry

THREADS = 128  # a block: four warps, a centroid row each


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("group_pool").pc2im_group_maxpool
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def group_maxpool_cuda(features: torch.Tensor, idx: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32, (B, M, S) int32 and bool CUDA -> (B, M, C) float32, on the current stream.

    features, idx and mask as `group_maxpool` takes them.  A warp a centroid row reads each valid slot's feature row once, as
    float4 lanes where C is a multiple of 4 and the table 16 B aligned,
    else as scalar lanes; the valid slots' indices must lie in [0, N).
    """
    registry.require_cuda_tensor(features, "features", torch.float32, 3)
    registry.require_cuda_tensor(idx, "idx", torch.int32, 3)
    registry.require_cuda_tensor(mask, "mask", torch.bool, 3)
    b, n, c = features.shape
    if idx.shape != mask.shape or idx.shape[0] != b:
        raise ValueError(
            f"expected features (B, N, C), idx and mask (B, M, S), got "
            f"{tuple(features.shape)}, {tuple(idx.shape)} and {tuple(mask.shape)}"
        )
    if idx.device != features.device or mask.device != features.device:
        raise ValueError("features, idx and mask must lie on the same device")
    m, s = idx.shape[1:]
    if s < 1:
        raise ValueError(f"need at least one neighbour slot, got S={s}")
    out = torch.empty((b, m, c), dtype=torch.float32, device=features.device)
    if b * m == 0 or c == 0:
        return out
    if n < 1:
        raise ValueError("features hold no point for the neighbour indices to name")
    vec4 = c % 4 == 0 and features.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(features.device).cuda_stream
    status = build.launch(
        _entry(), features.device, features.data_ptr(), idx.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b * m, m, n, s, c, int(vec4), THREADS, stream,
    )
    build.check(status, "group_pool")
    registry.count_launch("group_maxpool", stream)
    return out
