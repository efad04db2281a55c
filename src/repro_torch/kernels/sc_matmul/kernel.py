"""Launch wrapper of the SC integer matmul kernel (`csrc/sc_matmul.cu`)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.build import N_SMS

# Block tile of csrc/sc_matmul.cu (rows, columns, k a step; the C entry point
# refuses a workspace too small for its own tile).
TILE_M, TILE_N, TILE_K = 64, 64, 32
MAX_SPLITS = 16
MIN_STEPS_PER_SPLIT = 2


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("sc_matmul").pc2im_sc_matmul
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def k_splits(m: int, n: int, k: int) -> int:
    """How many blocks share one output tile's K range for an (m, k) x (k, n) product.

    Only a product with a single row of tiles (m <= TILE_M, the cls head's
    M = 8) is split: its few tiles would leave most SMs idle.  The split
    aims at one block an SM, keeps at least MIN_STEPS_PER_SPLIT k steps a
    block, and leaves no split empty.
    """
    for name, v in (("m", m), ("n", n), ("k", k)):
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{name}={v!r} must be a positive int")
    if m > TILE_M:
        return 1
    tiles = -(-n // TILE_N)
    steps = -(-k // TILE_K)
    want = min(MAX_SPLITS, -(-N_SMS // tiles), steps // MIN_STEPS_PER_SPLIT)
    if want <= 1:
        return 1
    per = -(-steps // want)
    return -(-steps // per)


def sc_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor, *, n_planes: int = 4) -> torch.Tensor:
    """(M, K) x (K, N) int32 CUDA -> (M, N) float32, launched on the current stream.

    Operands must hold values of 4 * n_planes bits (two's complement), or
    2^(4 * n_planes - 1), the largest a bf16 quantizer gives; the kernel
    splits each 4-bit plane into an s8 tensor-core operand.  Where
    `k_splits` splits K, the partial sums meet in a zeroed int32 workspace.
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
    splits = k_splits(m, n, k)
    ws = None
    if splits > 1:  # partial diagonals, then one arrival counter a tile
        tiles = -(-m // TILE_M) * -(-n // TILE_N)
        ws = torch.zeros((2 * n_planes - 1) * m * n + tiles, dtype=torch.int32,
                         device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    status = build.launch(
        _entry(), x_q.device, x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), 0 if ws is None else ws.numel(),
        m, n, k, n_planes, splits, stream,
    )
    build.check(status, "sc_matmul")
    registry.count_launch("sc_matmul", stream)
    return out
