"""Launch wrapper of the SC integer matmul kernel (`csrc/sc_matmul.cu`)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("sc_matmul").pc2im_sc_matmul
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def sc_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor, *, n_planes: int = 4) -> torch.Tensor:
    """(M, K) x (K, N) int32 CUDA -> (M, N) float32, launched on the current stream.

    Operands must hold values of 4 * n_planes bits (two's complement); the
    kernel packs each 4-bit plane into a byte.
    """
    registry.require_cuda_tensor(x_q, "x_q", torch.int32, 2)
    registry.require_cuda_tensor(w_q, "w_q", torch.int32, 2)
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"inner dims differ: x_q {tuple(x_q.shape)}, w_q {tuple(w_q.shape)}")
    if w_q.device != x_q.device:
        raise ValueError("x_q and w_q must lie on the same device")
    if not 1 <= n_planes <= 4:
        raise ValueError(f"n_planes={n_planes} must be in 1..4 (4 to 16-bit operands)")
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    status = _entry()(
        x_q.device.index, x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(),
        m, n, k, n_planes, stream,
    )
    build.check(status, "sc_matmul")
    registry.count_launch("sc_matmul")
    return out
