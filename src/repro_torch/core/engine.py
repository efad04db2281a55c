"""Batched PreprocessEngine — end-to-end (B, N, 3) preprocessing, one launch a kernel.

A `PreprocessEngine` is built once from an `EngineConfig` and maps a whole
batch of clouds to a batched `PreprocessResult`:

    engine = PreprocessEngine(EngineConfig(pipeline="pc2im", n_centroids=128,
                                           radius=0.3, nsample=16, depth=3))
    res = engine(points)          # points (B, N, 3) -> fields lead with B

The key dataflow move: batch and MSP tiles are FOLDED INTO ONE TILE AXIS.
After partitioning, the B clouds' 2^depth tiles become one (B·T, P, 3)
tensor, and the FPS and lattice kernels each launch once for the whole
batch (the paper's C2 equal-size tiles extended to the batch dim).

The three pipelines of `core/preprocess.py` run here, each bitwise equal to
stacking its per-cloud oracle:
  * pc2im: MSP, then the FPS kernel (L1) and the lattice-tiles kernel over
    the folded tiles; `query="ball"` swaps the lattice kernel for the ball
    query;
  * baseline1: the FPS kernel (L2) with the B clouds as its tiles, one
    launch for the batch, then the ball query over each whole cloud;
  * baseline2: the grid partition, the masked FPS and the ball query.
Three of these ops have no kernel, as in the reference, which runs them in
XLA on every backend: the ball query, the grid partition and the masked
FPS are plain torch ops on every device.  They are not registry kernels and
count no launch; nothing hands them a CUDA tensor in place of a kernel.
Kernels run for CUDA tensors and their plain versions for CPU tensors
(kernels/registry); nothing falls back.
"""

from __future__ import annotations

import dataclasses
import functools
import io
from typing import Literal

import numpy as np
import torch

from repro_torch.core import partition as part_mod
from repro_torch.core import preprocess as pp_mod
from repro_torch.core import query as query_mod
from repro_torch.core.device import synchronize
from repro_torch.core.preprocess import PreprocessResult
from repro_torch.core.query import NeighborSet
from repro_torch.kernels.fps.ops import fps_tiles
from repro_torch.kernels.lattice.ops import lattice_query_tiles

Pipeline = Literal["baseline1", "baseline2", "pc2im"]
QUERIES = ("lattice", "ball")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static description of one preprocessing pipeline instance.

    metric/query default to the pipeline's canonical choice (pc2im: L1 +
    lattice; baselines: L2 + ball) and can be overridden to mix, e.g. MSP
    tiles with an L2 ball query for ablations.
    """

    pipeline: Pipeline = "pc2im"
    n_centroids: int = 128
    radius: float = 0.3
    nsample: int = 16
    depth: int = 3  # MSP: tiles = 2^depth (pc2im only)
    axis_mode: str = "widest"
    metric: str | None = None  # None -> pipeline default
    query: str | None = None  # None -> pipeline default
    grid: int = 2  # baseline2 spatial grid
    capacity: int | None = None  # baseline2 tile capacity (None -> 2x mean)
    backend: str | None = "auto"  # "auto" | "pallas" | "xla" (kernels/registry)

    @property
    def resolved_metric(self) -> str:
        """FPS distance metric with the None placeholder resolved."""
        if self.metric is not None:
            return self.metric
        return "l1" if self.pipeline == "pc2im" else "l2"

    @property
    def resolved_query(self) -> str:
        """Neighbour-query kind with the None placeholder resolved."""
        if self.query is not None:
            return self.query
        return "lattice" if self.pipeline == "pc2im" else "ball"

    @property
    def n_tiles(self) -> int:
        """Tiles per cloud seen by the FPS (1 for the global baseline1)."""
        if self.pipeline == "pc2im":
            return 1 << self.depth
        if self.pipeline == "baseline2":
            return self.grid**3
        return 1


def clamp_depth(n_points: int, n_centroids: int, depth: int) -> int:
    """Largest usable MSP depth <= `depth` for a given cloud/sample size.

    Keeps tiles no smaller than 4x the per-tile sample count and requires
    both N and n_centroids to split evenly (the MSP equal-tile property).
    """
    while depth > 0 and (n_points >> depth) < 4 * max(1, n_centroids >> depth):
        depth -= 1
    while depth > 0 and (n_points % (1 << depth) or n_centroids % (1 << depth)):
        depth -= 1
    return depth


class PreprocessEngine:
    """Batched preprocessing: (B, N, 3) -> PreprocessResult.

    Output fields lead with the batch dim: centroid_idx (B, M) int32,
    centroid_xyz (B, M, 3), neighbors.idx (B, M, nsample) int32 and .mask,
    centroid_valid (B, M), with M = n_centroids and indices global per cloud.
    A single (N, 3) cloud is accepted and returns unbatched fields.
    """

    def __init__(self, config: EngineConfig):
        if config.pipeline not in pp_mod.PIPELINES:
            raise ValueError(f"unknown pipeline {config.pipeline!r}")
        if config.resolved_query not in QUERIES:
            raise ValueError(f"unknown query {config.resolved_query!r}; use one of {QUERIES}")
        if config.pipeline == "pc2im" and config.n_centroids % config.n_tiles:
            raise ValueError(
                f"n_centroids={config.n_centroids} not divisible by "
                f"2^depth={config.n_tiles} tiles"
            )
        self.config = config
        self._fn = {"baseline1": self._baseline1, "baseline2": self._baseline2,
                    "pc2im": self._pc2im}[config.pipeline]

    def __call__(self, points: torch.Tensor) -> PreprocessResult:
        """Run the pipeline on (B, N, 3) or single (N, 3) coordinates.

        See the class docstring for the output layout.
        """
        if points.ndim == 2:
            if points.shape[-1] != 3:
                raise ValueError(f"expected (B, N, 3) or (N, 3), got {tuple(points.shape)}")
            res = self(points[None])
            return PreprocessResult(
                res.centroid_idx[0], res.centroid_xyz[0],
                NeighborSet(res.neighbors.idx[0], res.neighbors.mask[0]),
                res.centroid_valid[0],
            )
        if points.ndim != 3 or points.shape[-1] != 3:
            raise ValueError(f"expected (B, N, 3) or (N, 3), got {tuple(points.shape)}")
        cfg = self.config
        if cfg.pipeline == "pc2im" and points.shape[1] % cfg.n_tiles:
            raise ValueError(
                f"N={points.shape[1]} not divisible by 2^depth={cfg.n_tiles}; "
                f"pad the clouds or lower depth (see clamp_depth)"
            )
        return self._fn(points)

    def _baseline1(self, points: torch.Tensor) -> PreprocessResult:
        """Global FPS + global ball query; the B clouds ARE the FPS kernel's tiles."""
        cfg = self.config
        b = points.shape[0]
        cidx = fps_tiles(
            points, cfg.n_centroids, metric=cfg.resolved_metric, backend=cfg.backend
        ).long()  # (B, M)
        cxyz = torch.take_along_dim(points, cidx[..., None], dim=1)  # (B, M, 3)
        nbrs = query_mod.ball_query(points, cxyz, cfg.radius, cfg.nsample)
        return PreprocessResult(
            cidx.to(torch.int32), cxyz, nbrs,
            torch.ones((b, cfg.n_centroids), dtype=torch.bool, device=points.device),
        )

    def _baseline2(self, points: torch.Tensor) -> PreprocessResult:
        """TiPU-like ragged grid tiles: the masked flow of the per-cloud oracle, batched.

        Plain torch ops on every device (no kernel takes a valid mask).
        """
        cfg = self.config
        return pp_mod.preprocess_baseline2(points, cfg.n_centroids, cfg.radius, cfg.nsample,
                                           grid=cfg.grid, capacity=cfg.capacity)

    def _pc2im(self, points: torch.Tensor) -> PreprocessResult:
        """MSP tiles + local FPS + local query; batch x tiles fold into one (B·T, P) launch."""
        cfg = self.config
        b, n, _ = points.shape
        t = cfg.n_tiles
        p = n // t
        k = cfg.n_centroids // t

        # per-cloud MSP (batched stable argsorts); tiles (B, T, P) global per cloud
        tiles = part_mod.median_partition(points, cfg.depth, axis_mode=cfg.axis_mode).tiles

        # FOLD: (B, T, P, 3) -> (B·T, P, 3); one kernel launch for all clouds
        flat_tiles = tiles.reshape(b * t, p)
        flat_coords = torch.take_along_dim(
            points, tiles.reshape(b, t * p, 1), dim=1
        ).reshape(b * t, p, 3)

        local_c = fps_tiles(
            flat_coords, k, metric=cfg.resolved_metric, backend=cfg.backend
        ).long()  # (B·T, k) local
        cidx = torch.take_along_dim(flat_tiles, local_c, dim=1)  # global
        cxyz = torch.take_along_dim(flat_coords, local_c[..., None], dim=1)

        if cfg.resolved_query == "lattice":
            nbrs_local = lattice_query_tiles(
                flat_coords, cxyz, cfg.radius, cfg.nsample, backend=cfg.backend
            )
        else:  # per-tile ball query: a plain op, as in the reference
            nbrs_local = query_mod.ball_query(flat_coords, cxyz, cfg.radius, cfg.nsample)
        # local tile slots -> global point indices
        nidx = torch.take_along_dim(flat_tiles[:, None, :], nbrs_local.idx.long(), dim=2)

        m = t * k
        return PreprocessResult(
            centroid_idx=cidx.reshape(b, m).to(torch.int32),
            centroid_xyz=cxyz.reshape(b, m, 3),
            neighbors=NeighborSet(
                idx=nidx.reshape(b, m, cfg.nsample).to(torch.int32),
                mask=nbrs_local.mask.reshape(b, m, cfg.nsample),
            ),
            centroid_valid=torch.ones((b, m), dtype=torch.bool, device=points.device),
        )


@functools.lru_cache(maxsize=None)
def get_engine(config: EngineConfig) -> PreprocessEngine:
    """Engine cache: one engine per distinct config (models build one per SA stage)."""
    return PreprocessEngine(config)


# -- result trees: size accounting, per-row access, serialization -------------
#
# A "result tree" is a PreprocessResult, or the tuple of them (one per SA
# stage) that the accelerator's preprocess_stage returns: NamedTuples and
# tuples whose leaves are torch tensors (on any device) or numpy arrays.
# The cross-request preprocess cache (serve/preprocess_cache.py) stores
# these per request row and re-assembles them per micro-batch.  The walk
# below visits leaves in field order, which is JAX's tree-flatten order for
# the same NamedTuples, so `serialize_result` writes the same npz leaves in
# both packages.


def _is_node(x) -> bool:
    return isinstance(x, tuple)


def result_leaves(res) -> list:
    """Every leaf of a result tree, depth first in field order."""
    if _is_node(res):
        return [leaf for child in res for leaf in result_leaves(child)]
    return [res]


def result_map(fn, res, *rest):
    """Apply fn leaf-wise over one or more result trees of the same structure.

    NamedTuples are rebuilt as their own type, plain tuples as tuples; the
    structures must match (a ValueError names the first mismatch).
    """
    if _is_node(res):
        for other in rest:
            if not _is_node(other) or len(other) != len(res):
                raise ValueError("result trees differ in structure")
        children = [result_map(fn, *parts) for parts in zip(res, *rest)]
        return type(res)(*children) if hasattr(res, "_fields") else tuple(children)
    for other in rest:
        if _is_node(other):
            raise ValueError("result trees differ in structure")
    return fn(res, *rest)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def result_nbytes(res) -> int:
    """Total bytes of every leaf of a result tree (tensor or numpy leaves)."""
    return int(sum(_nbytes(x) for x in result_leaves(res)))


def result_to_host(res):
    """Every leaf of a result tree as a WRITABLE numpy array of its own.

    A CUDA leaf may have been written on any stream of its device, so the
    device is synchronised once before the (synchronous) copies: the host
    reads the finished values whichever stream or thread made them (never
    during another thread's graph capture, which that would invalidate:
    `core.device.synchronize`).  Every
    leaf is copied, so writing a returned array (`result_set_row`) never
    touches the tensor it came from.
    """
    leaves = result_leaves(res)
    for dev in {x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda}:
        synchronize(dev)

    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True).numpy()
        return np.array(x, copy=True)

    return result_map(one, res)


def result_to(res, device: torch.device):
    """A result tree with every leaf as a tensor on `device`.

    Tensor leaves already there are kept as they are; numpy leaves are
    copied (cached payloads are read-only arrays, which a tensor must not
    alias).
    """

    def one(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.tensor(x, device=device)

    return result_map(one, res)


def result_row(res, i: int):
    """Slice row `i` off every leaf's leading (batch) dim of a result tree.

    The per-request payload the preprocess cache stores: one cloud's
    centroids/neighborhoods out of a batched PreprocessResult.
    """
    return result_map(lambda x: x[i], res)


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(x)


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def result_stack(rows, total: int | None = None, filler=None):
    """Stack per-row result trees back into one batched tree.

    `rows` are `result_row`-shaped trees (all the same structure, all numpy
    or all tensors on one device); `total` > len(rows) appends filler rows
    so the stacked batch has the static batch dim.  The filler is `filler`
    (a row tree of the same kind), else zeros.  A batch whose feature stage
    must equal `infer` of the padded batch passes the preprocessing of
    assemble_batch's zero filler cloud: under SC the activation scale spans
    every row, so zero rows in its place move the real rows' logits.
    """
    rows = list(rows)
    if not rows:
        raise ValueError("need at least one row to stack")
    if total is not None and total > len(rows):
        if filler is None:
            filler = result_map(_zeros_like, rows[0])
        rows.extend([filler] * (total - len(rows)))
    return result_map(_stack, *rows)


def result_set_row(res, i: int, row) -> None:
    """Write a per-row tree into row `i` of a batched HOST result tree.

    In-place: `res` leaves must be writable numpy arrays (use
    `result_to_host` first).  This is the cache-hit splice — a hit row's
    cached neighborhoods replace whatever the batched preprocess computed
    for that row before the feature stage consumes the tree.
    """

    def put(dst, src):
        dst[i] = src

    result_map(put, res, row)


def serialize_result(res) -> bytes:
    """Pack a result tree's leaves into one portable npz byte blob.

    Leaves are stored in tree order (that of JAX's tree-flatten for the
    same result); the tree STRUCTURE is not encoded — pass a structurally
    identical template to `deserialize_result` to rebuild.
    """
    leaves = result_leaves(result_to_host(res))
    buf = io.BytesIO()
    np.savez(buf, *leaves)
    return buf.getvalue()


def deserialize_result(blob: bytes, like):
    """Rebuild a result tree from `serialize_result` bytes.

    `like` supplies the tree structure (any tree with the same topology,
    e.g. a live entry's payload); leaves come back as numpy arrays, dtype
    and shape preserved bitwise.
    """
    with np.load(io.BytesIO(blob)) as data:
        leaves = iter([data[k] for k in data.files])
    return result_map(lambda _: next(leaves), like)
