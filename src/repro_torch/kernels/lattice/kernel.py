"""Launch wrappers of the lattice query kernel (`csrc/lattice.cu`): per tile and flat."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.build import N_SMS

THREADS = 256  # a block: 8 warps
MAX_CHUNK = 4096  # points staged at a time: 48 KB of shared memory
MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use
TARGET_WARPS = 16 * N_SMS  # warps that keep every SM busy while rows are few
MAX_SPLIT_NSAMPLE = 256  # rows with more slots are never split (shared hit buffers)


class LatticePlan(NamedTuple):
    """How csrc/lattice.cu splits a call.

    `warps_per_row` warps share a row (each walks a segment of the staged
    points), a block serves `rows_per_block` rows of one tile, stages `chunk`
    points at a time and walks `unroll` chunks of 32 points a step, with
    `threads` a block.
    """

    warps_per_row: int
    rows_per_block: int
    unroll: int
    chunk: int
    threads: int

    def padded_chunk(self) -> int:
        """A full chunk padded to whole steps of every warp's segment."""
        step = 32 * self.unroll * self.warps_per_row
        return -(-self.chunk // step) * step

    def smem_bytes(self, nsample: int) -> int:
        """Shared memory of a block in bytes (csrc/lattice.cu lattice_smem_bytes).

        The staged points, the rows' centroids, counts and first hits, and the
        split rows' segment counts and hits.
        """
        n = 4 * (3 * self.padded_chunk() + 5 * self.rows_per_block)
        if self.warps_per_row > 1:
            n += 4 * (self.threads // 32) * (1 + nsample)
        return n


def lattice_plan(t: int, k: int, p: int, nsample: int) -> LatticePlan:
    """The plan for T tiles of K centroids among P points each, `nsample` slots a row.

    Rows are shared by warps only while there are fewer than TARGET_WARPS
    warps' worth of them, and only as far as every warp keeps two steps of
    points of its own; a block then takes as many rows as still leaves two
    blocks an SM (up to four rounds of its row groups).  At every main-path
    and flat shape this is the fastest plan timed on an H100.
    """
    for name, v in (("t", t), ("k", k), ("p", p), ("nsample", nsample)):
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{name}={v!r} must be a positive int")
    warps = THREADS // 32
    unroll = 2 if p <= 64 else 4
    rows = t * k
    w = 1
    while (w < warps and 2 * w * rows <= TARGET_WARPS and p >= 2 * (2 * w) * 32 * unroll
           and nsample <= MAX_SPLIT_NSAMPLE):
        w *= 2
    groups = warps // w
    rounds = 1
    while rounds < 4 and t * -(-k // (2 * rounds * groups)) >= 2 * N_SMS:
        rounds *= 2
    plan = LatticePlan(w, min(k, rounds * groups), unroll, min(p, MAX_CHUNK), THREADS)
    if plan.smem_bytes(nsample) > MAX_SMEM:
        raise ValueError(f"nsample={nsample} needs more shared memory than a block has")
    return plan


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("lattice").pc2im_lattice_tiles
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(
    coords: torch.Tensor, centroids: torch.Tensor, nsample: int, l_range: float, name: str,
    plan: LatticePlan | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (T, P, 3) / (T, K, 3) tensors, counting it as `name`.

    `plan` is `lattice_plan`'s choice unless given.  Nothing is launched (or
    counted) when there is no centroid.
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
    plan = lattice_plan(t, kk, p, nsample) if plan is None else plan
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    status = build.launch(
        _entry(), coords.device, coords.data_ptr(), centroids.data_ptr(),
        idx.data_ptr(), mask.data_ptr(), t, kk, p, nsample,
        ctypes.c_float(np.float32(l_range)), *plan, stream,
    )
    build.check(status, "lattice")
    registry.count_launch(name, stream)
    return idx, mask


def lattice_tiles_cuda(
    coords: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float,
    _plan: LatticePlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """coords (T, P, 3), centroids (T, K, 3) float32 CUDA -> idx int32, mask bool.

    Each block stages one tile's points in shared memory for its rows, as
    `lattice_plan` chooses (`_plan` overrides it, for the tests of other
    plans), launched on the current stream.  `l_range` is rounded to float32
    once, here, as the reference compares it.
    """
    registry.require_cuda_tensor(coords, "coords", torch.float32, 3)
    registry.require_cuda_tensor(centroids, "centroids", torch.float32, 3)
    return _launch(coords, centroids, nsample, l_range, "lattice_tiles", _plan)


def lattice_query_cuda(
    points: torch.Tensor, centroids: torch.Tensor, *, nsample: int, l_range: float,
    _plan: LatticePlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """points (P, 3), centroids (M, 3) float32 CUDA -> idx (M, nsample) int32, mask bool.

    The flat query: the same kernel over one set, launched as one tile
    holding all M centroids and all P points (`_plan` as for lattice_tiles_cuda).
    """
    registry.require_cuda_tensor(points, "points", torch.float32, 2)
    registry.require_cuda_tensor(centroids, "centroids", torch.float32, 2)
    idx, mask = _launch(points[None], centroids[None], nsample, l_range, "lattice_query", _plan)
    return idx[0], mask[0]
