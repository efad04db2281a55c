"""Farthest point sampling (FPS): distances, the masked per-cloud oracle, the
quantized-coordinate L1 datapath and sampling-quality metrics (paper C1, C3).

The FPS inner loop is

    d_tmp  <- min(d_tmp, dist(points, points[last]))     # temporary-distance update
    last   <- argmax(d_tmp)                              # next centroid

and `fused_fps_step` is one step of it.  Distances:
  * metric="l2" : squared Euclidean (no sqrt — monotone, what baselines use)
  * metric="l1" : Manhattan (paper C1).  With 16-bit quantized coordinates
    the L1 distance fits in 19 bits (3 * (2^16 - 1) < 2^18).

The three coordinate terms are summed as (x + y) + z, written out rather
than left to a reduction, so the plain versions, the CUDA kernels and the
JAX reference add in the same order and agree to the bit.

`fps`, `fps_batched` and the rest are plain torch ops on every device, as
the reference runs them in XLA on every backend: the masked FPS has no
kernel (kernels/fps is the unmasked tile kernel).  Each step is a fixed
sequence of device ops (no read-back to the host), so a CUDA graph can
capture the loop.
"""

from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["l1", "l2"]

_BIG = 1e30  # the reference's float32 1e30: the starting dmin, -BIG for masked slots


def coord_sum(terms: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): (t0 + t1) + t2, in that order."""
    return (terms[..., 0] + terms[..., 1]) + terms[..., 2]


def point_distance(diff: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """Distance for coordinate differences: (..., 3) -> (...)."""
    if metric == "l1":
        return coord_sum(diff.abs())
    if metric == "l2":
        return coord_sum(diff * diff)
    raise ValueError(f"metric must be 'l1' or 'l2', got {metric!r}")


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """Distance matrix between point sets.  a: (..., N, 3), b: (..., M, 3) -> (..., N, M).

    L2 returns the *squared* distance; L1 the Manhattan distance (paper eq. 2).
    Leading dims broadcast, so a batch of tiles works unchanged.
    """
    return point_distance(a[..., :, None, :] - b[..., None, :, :], metric)


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of `like`'s dtype made on its device (a fill: capturable)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def fused_fps_step(points: torch.Tensor, dmin: torch.Tensor, last_idx: torch.Tensor,
                   metric: Metric = "l2", valid: torch.Tensor | None = None) -> tuple:
    """One Ping-Pong-MAX step: distance + min-update + argmax (C3).

    points (..., N, 3), dmin (..., N), last_idx (...) int64 -> (new_dmin
    (..., N), next_idx (...) int64).  `valid` (..., N) masks padded points
    out of the argmax: they score -1e30, so they are sampled only when no
    slot is valid.  Ties go to the first index (torch.argmax's rule).
    """
    lead = points.shape[:-2]
    ref = torch.take_along_dim(points, last_idx.reshape(*lead, 1, 1), dim=-2)  # (..., 1, 3)
    new_dmin = torch.minimum(dmin, point_distance(points - ref, metric))
    score = new_dmin if valid is None else torch.where(valid, new_dmin, _full(new_dmin, -_BIG))
    return new_dmin, torch.argmax(score, dim=-1)


def first_valid(valid: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim, 0 where there is none: (..., N) -> (...).

    torch.argmax has no bool kernel, so the mask is cast to int32 first.
    """
    return torch.argmax(valid.to(torch.int32), dim=-1)


def fps_batched(points: torch.Tensor, k: int, *, metric: Metric = "l2",
                valid: torch.Tensor | None = None,
                start_idx: int | None = None) -> torch.Tensor:
    """Sequential FPS over any number of leading batch/tile dims.

    points (..., N, 3) -> (..., k) int32 indices local to each cloud or
    tile.  The first sample is `start_idx` if given, else the first valid
    slot (`first_valid`; index 0 without a mask), so a tile whose slot 0
    is padding never seeds the sample with a fake point.  A tile with fewer
    valid points than k samples its first valid maximum again; an
    all-invalid tile samples slot 0.
    """
    n = points.shape[-2]
    if k > n:
        raise ValueError(f"cannot sample {k} from {n} points")
    lead = points.shape[:-2]
    dmin = torch.full((*lead, n), _BIG, dtype=points.dtype, device=points.device)
    if start_idx is not None:
        last = torch.full(lead, start_idx, dtype=torch.int64, device=points.device)
    elif valid is not None:
        last = first_valid(valid)
    else:
        last = torch.zeros(lead, dtype=torch.int64, device=points.device)
    picks = []
    for _ in range(k):
        picks.append(last)
        dmin, last = fused_fps_step(points, dmin, last, metric, valid)
    return torch.stack(picks, dim=-1).to(torch.int32)


def fps(points: torch.Tensor, k: int, *, metric: Metric = "l2", start_idx: int | None = None,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sequential farthest point sampling of one cloud.  points: (N, 3) -> indices (k,) int32.

    The start is `start_idx`, else the first valid slot (index 0 when no
    mask is given, the PointNet++ convention); see `fps_batched`.
    """
    if points.ndim != 2:
        raise ValueError(f"expected one (N, 3) cloud, got {tuple(points.shape)}")
    return fps_batched(points, k, metric=metric, valid=valid, start_idx=start_idx)


# ---------------------------------------------------------------------------
# Quantized-coordinate L1 FPS (the APD-CIM datapath: int16 coords, 19-bit
# distances).
# ---------------------------------------------------------------------------


def quantize_coords(points: torch.Tensor, bits: int = 16) -> tuple:
    """Quantize float coords to signed ints on a uniform grid (paper: 16-bit PTQ).

    points (..., 3): the range is taken over every dim but the last.
    Returns (q int32 in [-2^(b-1), 2^(b-1)-1], scale, offset) such that
    points ~= q * scale + offset.  The divisors are tensors on the data's
    device, so a CUDA run divides as the CPU does.
    """
    dims = tuple(range(points.ndim - 1))
    lo = points.amin(dim=dims, keepdim=True)
    hi = points.amax(dim=dims, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    levels = (1 << bits) - 1
    scale = span / _full(span, levels)
    half = 1 << (bits - 1)
    q = torch.clamp(torch.round((points - lo) / scale) - half, -half, half - 1)
    return q.to(torch.int32), scale, lo + half * scale


def fps_l1_quantized(points_q: torch.Tensor, k: int, *, start_idx: int = 0) -> torch.Tensor:
    """Integer L1 FPS over pre-quantized coords — exact APD-CIM arithmetic.

    points_q: (N, 3) int32 (16-bit range) -> (k,) int32.  Distances are
    exact 19-bit ints; dmin starts at 2^30; ties go to the first index.
    """
    n = points_q.shape[0]
    dmin = torch.full((n,), 2**30, dtype=torch.int32, device=points_q.device)
    last = torch.full((), start_idx, dtype=torch.int64, device=points_q.device)
    picks = []
    for _ in range(k):
        picks.append(last)
        ref = points_q[last]
        d = (points_q - ref).abs().sum(dim=-1, dtype=torch.int32)  # <= 3 (2^16 - 1): 19 bits
        dmin = torch.minimum(dmin, d)
        last = torch.argmax(dmin)
    return torch.stack(picks).to(torch.int32)


# ---------------------------------------------------------------------------
# Sampling-quality metrics (the Fig 12a analogue: how good is the
# L1-approximate sample against exact-L2 FPS?)
# ---------------------------------------------------------------------------


def _take_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3), idx (..., k) -> (..., k, 3)."""
    return torch.take_along_dim(points, idx.long()[..., None], dim=-2)


def coverage_radius(points: torch.Tensor, sample_idx: torch.Tensor) -> torch.Tensor:
    """max_p min_s ||p - s||2 — the covering radius of the sampled subset (lower=better).

    points (..., N, 3), sample_idx (..., k) -> (...).
    """
    d = pairwise_distance(points, _take_points(points, sample_idx), "l2")  # (..., N, k)
    return torch.sqrt(d.amin(dim=-1).amax(dim=-1))


def min_pairwise_separation(points: torch.Tensor, sample_idx: torch.Tensor) -> torch.Tensor:
    """min_{i!=j} ||s_i - s_j||2 — FPS maximises spread (higher=better).

    points (..., N, 3), sample_idx (..., k) -> (...).  The diagonal is
    lifted by 1e30, as in the reference.
    """
    c = _take_points(points, sample_idx)
    d = pairwise_distance(c, c, "l2")
    k = c.shape[-2]
    d = d + torch.eye(k, dtype=d.dtype, device=d.device) * _BIG
    return torch.sqrt(d.amin(dim=(-2, -1)))
