"""Plain PyTorch version of the SC matmul kernel (core.quant's float32 combine)."""

from __future__ import annotations

import torch

from repro_torch.core.quant import sc_matmul


def sc_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, *, n_planes: int = 4) -> torch.Tensor:
    """(M, K) x (K, N) int32 -> (M, N) float32, the kernel's arithmetic schedule."""
    return sc_matmul(x_q, w_q, n_planes=n_planes, combine="f32")
