"""Batched point-cloud inference — ragged requests onto static engine shapes.

Serving traffic arrives as clouds of arbitrary size in arbitrary batches;
the PC2IMAccelerator takes a fixed (B, N, 3+F).  This module is the
adapter:

  * clouds smaller than cfg.n_points are padded by repeating the last point
    (duplicates collapse to one FPS candidate, the standard convention);
  * clouds larger than cfg.n_points are deterministically strided down —
    the paper's pipelines all assume a fixed-budget input stage;
  * partial batches are zero-padded to `batch_size` and the filler rows
    dropped from the output.

One `PC2IMAccelerator` (config + ExecutionPolicy + device) serves every
request shape; pass a policy to serve quantized (SC W16A16) without
touching the config, safely per-thread.  The accelerator runs on the card
unless `device="cpu"` is passed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import pointnet2 as PN


@dataclasses.dataclass(frozen=True)
class PointCloudServeConfig:
    """Knobs of the synchronous batch-serving path (`make_pointcloud_serve_fns`).

    batch_size is the static batch dim every ragged request chunk is padded
    to, whatever number of clouds a caller hands in.
    """

    batch_size: int = 8  # static serving batch (pad + drop filler rows)


def pad_cloud(points: np.ndarray, n_points: int) -> tuple[np.ndarray, int]:
    """Fit one (n, F>=3) cloud to exactly n_points rows.

    Returns (fitted cloud, n) with the ORIGINAL row count, so callers can
    recover which rows are real (n < n_points: the first n) or reverse the
    deterministic stride subsample (n > n_points: see subsample_indices).
    """
    n = points.shape[0]
    if n == n_points:
        return points, n
    if n > n_points:  # deterministic stride subsample (fixed input budget)
        return points[subsample_indices(n, n_points)], n
    filler = np.broadcast_to(points[-1:], (n_points - n, points.shape[1]))
    return np.concatenate([points, filler], axis=0), n


def subsample_indices(n: int, n_points: int) -> np.ndarray:
    """Rows surviving pad_cloud's stride-subsample of an oversized cloud.

    Deterministic (a rounded linspace over the n input rows); exposed so
    seg callers can map per-point logits back to the original rows.
    """
    return np.linspace(0, n - 1, n_points).round().astype(np.int64)


def inverse_subsample_indices(n: int, n_points: int) -> np.ndarray:
    """Exact inverse of subsample_indices — nearest survivor per original row.

    For each of the n ORIGINAL rows, returns the position (in the n_points
    surviving rows) of its nearest survivor.  Guarantees, for any
    n > n_points >= 1 (property-tested):
      * identity  — a row that survived maps to its own slot, so per-point
        logits round-trip bitwise for surviving rows;
      * nearest   — every dropped row maps to the survivor with the smallest
        row-distance (ties -> the earlier survivor);
      * monotone  — the mapping is non-decreasing in the original row index.

    Built by searching the actual survivor set rather than re-deriving it
    from a second rounded linspace (the old inline approximation), so it can
    never drift off-by-one from whatever subsample_indices produces.
    """
    idx = subsample_indices(n, n_points)
    rows = np.arange(n)
    right = np.clip(np.searchsorted(idx, rows, side="left"), 0, n_points - 1)
    left = np.clip(right - 1, 0, n_points - 1)
    take_left = (rows - idx[left]) <= (idx[right] - rows)
    return np.where(take_left, left, right).astype(np.int64)


def make_pointcloud_serve_fns(
    cfg: PN.PointNet2Config,
    serve_cfg: PointCloudServeConfig | None = None,
    policy: ExecutionPolicy | None = None,
    device=None,
):
    """Serving closures for a PointNet2 config, on the card unless `device` says otherwise.

    Returns {"infer", "serve_batch", "accelerator"}:
      infer(params, points)       — the accelerator's batched forward on the
                                    static (batch_size, n_points, 3+F) shape.
      serve_batch(params, clouds) — ragged entry point: list of (n_i, 3+F)
                                    numpy clouds -> list of per-cloud logits
                                    (cls: (C,); seg: (n_i, C) — padding rows
                                    dropped, and oversized clouds mapped back
                                    to all n_i points via nearest sampled
                                    point, so row j scores input point j).
      accelerator                 — the underlying PC2IMAccelerator (one
                                    per (cfg, policy, device)).
    """
    scfg = serve_cfg or PointCloudServeConfig()
    b, n = scfg.batch_size, cfg.n_points
    width = 3 + cfg.in_features
    accel = get_accelerator(cfg, policy, device=device)
    infer = accel.infer

    def serve_batch(params, clouds: list[np.ndarray]) -> list[np.ndarray]:
        out: list[np.ndarray] = []
        for lo in range(0, len(clouds), b):
            chunk = clouds[lo : lo + b]
            fitted = [pad_cloud(np.asarray(c, np.float32), n) for c in chunk]
            batch = np.zeros((b, n, width), np.float32)
            for i, (pts, _) in enumerate(fitted):
                batch[i] = pts
            logits = infer(params, batch).cpu().numpy()
            for i, (_, n_orig) in enumerate(fitted):
                if cfg.task != "seg":
                    out.append(logits[i])
                elif n_orig <= n:  # drop padding rows
                    out.append(logits[i, :n_orig])
                else:  # subsampled: nearest surviving point scores each input row
                    out.append(logits[i, inverse_subsample_indices(n_orig, n)])
        return out

    return {"infer": infer, "serve_batch": serve_batch, "accelerator": accel}
