"""Split-concatenate quantized MACs (paper C4 — SC-CIM), as exact integer math.

Arithmetic identity (two's-complement nibble decomposition):

    q = n0 + 16*n1 + 256*n2 + 4096*n3s,   n0..n2 in [0,15], n3s in [-8,7]

    x @ w = sum_{i,j} (X_i @ W_j) << 4*(i+j)

Plane pairs on one diagonal d = i + j share one shift, so their dots are
summed first (int32, exact) and shifted once — the software image of the
paper's fused adder tree.  This module is the plain version behind
`kernels/sc_matmul`; it runs on the CPU and on the card alike.

PyTorch has no int32 matmul on CUDA, so each plane-pair dot is a float64
matmul: every partial sum is an integer of magnitude <= 15 * 15 * K < 2^53,
which float64 holds exactly, and the result is cast to int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import hints

PLANE_BITS = 4
N_PLANES_16 = 4  # 16-bit operands -> 4 nibbles


class Quantized(NamedTuple):
    """Integer values (int32) and the float32 scale that maps them back."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_symmetric(
    x: torch.Tensor, bits: int = 16, axis=None, *, axis_name: str | None = None
) -> Quantized:
    """Symmetric signed quantization: q = round(x / s), s = max|x| / (2^(b-1)-1).

    The scale is per tensor, or with `axis` (a dim or tuple of dims) one per
    slice along the other dims, kept as size-1 dims (the reference's
    `keepdims=True`).

    Rounds half to even and clips to [-2^(b-1), 2^(b-1)-1], like the
    reference.  Every divisor is a tensor on x's device: a CUDA division by a
    CPU scalar is computed as a multiplication by its reciprocal, which can
    differ in the last bit.

    axis_name: the bound replica axis (`sharding.hints.REPLICA_AXIS`) to
    take the amax's max over, so that every shard quantizes with the
    GLOBAL scale; max is exact, which keeps a batch-sharded quantized
    linear bitwise equal to the unsharded one.  The group's max comes back
    on x's device.
    """
    qmax = (1 << (bits - 1)) - 1
    amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    if axis_name is not None:
        amax = hints.all_max(amax, axis_name)
    qmax_t = torch.full((), qmax, dtype=x.dtype, device=x.device)  # no host copy: capturable
    scale = torch.clamp(amax, min=1e-12) / qmax_t
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int32)
    return Quantized(q=q, scale=scale)


def split_planes(q: torch.Tensor, n_planes: int = N_PLANES_16) -> torch.Tensor:
    """Nibble-decompose signed ints: (...) int32 -> (n_planes, ...) int32.

    Planes 0..n-2 are unsigned nibbles in [0,15]; the top plane is the
    arithmetic-shift remainder in [-8,7].
    """
    q = q.to(torch.int32)
    planes = [(q >> (PLANE_BITS * i)) & 0xF for i in range(n_planes - 1)]
    planes.append(q >> (PLANE_BITS * (n_planes - 1)))
    return torch.stack(planes, dim=0)


def diagonal_dots(x_q: torch.Tensor, w_q: torch.Tensor, n_planes: int = N_PLANES_16) -> list[torch.Tensor]:
    """Per-diagonal int32 sums: entry d is sum_{i+j=d} X_i @ W_j, (M, N) each."""
    xp = split_planes(x_q, n_planes).to(torch.float64)
    wp = split_planes(w_q, n_planes).to(torch.float64)
    diags: list[torch.Tensor | None] = [None] * (2 * n_planes - 1)
    for i in range(n_planes):
        for j in range(n_planes):
            dot = torch.matmul(xp[i], wp[j]).to(torch.int32)  # exact, see module doc
            d = i + j
            diags[d] = dot if diags[d] is None else diags[d] + dot
    return diags


def sc_matmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    *,
    n_planes: int = N_PLANES_16,
    combine: str = "int64",
) -> torch.Tensor:
    """Split-concatenate integer matmul: exact x_q @ w_q via 4-bit planes.

    x_q: (M, K) int32, w_q: (K, N) int32 -> (M, N).
    combine="int64": exact, int64 tensor.
    combine="f32"  : sum_d float32(acc_d) * 16^d in diagonal order from 0.0,
                     the kernel's arithmetic.
    """
    diags = diagonal_dots(x_q, w_q, n_planes)
    if combine == "int64":
        out = torch.zeros(diags[0].shape, dtype=torch.int64, device=x_q.device)
        for d, dot in enumerate(diags):
            out = out + (dot.to(torch.int64) << (PLANE_BITS * d))
        return out
    if combine == "f32":
        out = torch.zeros(diags[0].shape, dtype=torch.float32, device=x_q.device)
        for d, dot in enumerate(diags):
            out = out + dot.to(torch.float32) * float(1 << (PLANE_BITS * d))
        return out
    raise ValueError(f"unknown combine mode {combine!r}")


def dequantize(t: Quantized) -> torch.Tensor:
    """Back to float32: q * scale."""
    return t.q.to(torch.float32) * t.scale


def combine_planes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of split_planes: (n_planes, ...) int32 -> (...) = sum_i planes[i] << 4i."""
    out = torch.zeros_like(planes[0])
    for i in range(planes.shape[0]):
        out = out + (planes[i] << (PLANE_BITS * i))
    return out


def quantized_linear(x: torch.Tensor, w: torch.Tensor, *, bits: int = 16,
                     combine: str = "f32") -> torch.Tensor:
    """WbAb linear layer through the SC decomposition: quantize -> sc_matmul -> dequantize.

    x: (..., K) float, w: (K, N) float -> (..., N) float32.  The plain
    oracle of the reference's `quantized_linear` (the model's SC path goes
    through kernels/sc_matmul).
    """
    lead = x.shape[:-1]
    xq = quantize_symmetric(x.reshape(-1, x.shape[-1]), bits)
    wq = quantize_symmetric(w, bits)
    y = sc_matmul(xq.q, wq.q, n_planes=bits // PLANE_BITS, combine=combine)
    y = y.to(torch.float32) * (xq.scale * wq.scale)
    return y.reshape(*lead, w.shape[-1])


def ptq_error(x: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Relative RMS round-trip error of symmetric PTQ (Fig 12a's <0.3% claim): a 0-d float32."""
    t = quantize_symmetric(x, bits)
    err = dequantize(t) - x
    floor = torch.full((), 1e-12, dtype=x.dtype, device=x.device)
    return torch.sqrt((err**2).mean()) / torch.maximum(torch.sqrt((x**2).mean()), floor)
