"""Launch wrapper of the k-nearest-neighbour kernel (`csrc/knn3.cu`)."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.build import N_SMS

MAX_K = 8  # the kernel keeps its running top-k in registers, one instantiation per k
THREADS = 256  # a block
PER_LANE = 2  # queries a lane (csrc/knn3.cu R)
UNROLL = 4  # points a lane reads a step (csrc/knn3.cu kUnroll)


class Knn3Plan(NamedTuple):
    """How csrc/knn3.cu splits a call.

    `group` lanes share each query's points (a power of two up to 32), each
    lane carrying PER_LANE queries, `threads` a block.
    """

    group: int
    threads: int

    def queries_per_block(self) -> int:
        """Queries a block serves: its lane groups times the queries a lane."""
        return self.threads // self.group * PER_LANE


def knn3_plan(b: int, q: int, p: int, k: int) -> Knn3Plan:
    """The plan for B clouds of Q queries among P points, k neighbours.

    PER_LANE queries a lane and THREADS a block; 4 lanes a query where that
    still gives every SM a block, else 8 (at the seg FP shapes the fastest
    plans timed on an H100: FP1 takes 4, FP0 8); never more lanes than
    P / UNROLL, so that every lane has points of its own to scan.
    """
    for name, v in (("b", b), ("q", q), ("p", p), ("k", k)):
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{name}={v!r} must be a positive int")
    if k > MAX_K or p < k:
        raise ValueError(f"need 1 <= k <= min({MAX_K}, P), got k={k}, P={p}")
    group = 4 if b * -(-q // (THREADS // 4 * PER_LANE)) >= N_SMS else 8
    while group > 1 and group * UNROLL > p:
        group //= 2
    return Knn3Plan(group, THREADS)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("knn3").pc2im_knn3
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def knn3_cuda(
    queries: torch.Tensor, points: torch.Tensor, *, k: int = 3, metric: str = "l2",
    _plan: Knn3Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (B, Q, 3), points (B, P, 3) float32 CUDA -> idx (B, Q, k) int32, dist float32.

    `group` lanes share each query's points and merge their top-k lists, as
    `knn3_plan` chooses (`_plan` overrides it, for the tests of other
    plans); one launch for all B clouds, on the current stream; nothing
    synchronises.
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
    plan = knn3_plan(b, q, p, k) if _plan is None else _plan
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    status = build.launch(
        _entry(), queries.device, queries.data_ptr(), points.data_ptr(),
        idx.data_ptr(), dist.data_ptr(), b, q, p, k, int(metric == "l1"),
        plan.group, plan.threads, stream,
    )
    build.check(status, "knn3")
    registry.count_launch("knn3", stream)
    return idx, dist
