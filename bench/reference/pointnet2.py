"""Plain PyTorch reference of PointNet++ as the benchmark's configurations run it.

The benchmark holds every served or batched logit against this module.  It
is written from the published algorithms, in float32 with TF32 off, and
imports nothing but torch and numpy: no kernel, no graph, no cache, no
batching machinery of the program under test.

* Preprocessing (PC2IM): median-split partition (MSP) into 2^depth equal
  tiles along each tile's widest axis (stable sorts), L1 farthest point
  sampling in each tile from its first point (first index on ties), and
  the lattice query: each centroid's first `nsample` tile points within L1
  range 1.6 * radius, in index order, empty slots repeating the first hit.
* Features: delayed aggregation (the per-point MLP first, then gather and
  a max-pool over the real neighbours); LayerNorm with float32 statistics
  after every hidden linear, ReLU after each but the head's last.
* Segmentation: 3-NN of the finer level among the coarser (squared L2,
  lower index on ties), inverse-distance weights 1 / (d + 1e-8), a skip
  concatenation and the stage MLP; then the per-point head.
* SC W16A16 / W8A8: each linear quantizes its input (one scale over every
  row of the batch) and its weight symmetrically, round half to even, and
  takes their product exactly: the integers' product in float64, whose
  sums stay below 2^53, then one rounding to float32 and the two scales.

`forward` takes a whole batch, because under SC a cloud's logits depend on
the rows it was batched with.  `fit_cloud` and `scatter` redo what a
serving runtime does to ragged clouds: a deterministic stride for a cloud
larger than the bucket, the last point repeated for a smaller one, zero
rows to fill the batch, and the rows mapped back to the cloud's points.
"""

from __future__ import annotations

import numpy as np
import torch

LATTICE_RANGE_FACTOR = 1.6
FAR = 1e30  # the starting distance of FPS, and the masked slot of the max-pool
LN_EPS = 1e-5
QUANT_BITS = {"none": None, "sc_w16a16": 16, "sc_w8a8": 8}


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 matmul with TF32 off, whatever the process set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def clamp_depth(n_points: int, n_centroids: int, depth: int) -> int:
    """The deepest MSP split <= depth whose tiles keep 4 points a centroid and split evenly."""
    while depth > 0 and (n_points >> depth) < 4 * max(1, n_centroids >> depth):
        depth -= 1
    while depth > 0 and (n_points % (1 << depth) or n_centroids % (1 << depth)):
        depth -= 1
    return depth


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, ...) int -> (B, ..., C): rows of each cloud."""
    b = x.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.take_along_dim(x, flat[..., None], dim=1)
    return out.reshape(*idx.shape, x.shape[-1])


def median_partition(points: torch.Tensor, depth: int) -> torch.Tensor:
    """(B, N, 3) -> tiles (B, 2^depth, N / 2^depth) int64 point indices."""
    b, n, _ = points.shape
    tiles = torch.arange(n, device=points.device).expand(b, 1, n)
    for _ in range(depth):
        _, t, p = tiles.shape
        coords = _gather_rows(points, tiles)  # (B, t, p, 3)
        extent = coords.amax(dim=2) - coords.amin(dim=2)
        axis = torch.argmax(extent, dim=-1)  # widest, first on ties
        key = torch.take_along_dim(coords, axis[:, :, None, None], dim=3)[..., 0]
        order = torch.argsort(key, dim=-1, stable=True)
        tiles = torch.take_along_dim(tiles, order, dim=-1).reshape(b, 2 * t, p // 2)
    return tiles


def l1(diff: torch.Tensor) -> torch.Tensor:
    """(|dx| + |dy|) + |dz| over the last dim."""
    a = diff.abs()
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def sq_l2(diff: torch.Tensor) -> torch.Tensor:
    """(dx^2 + dy^2) + dz^2 over the last dim."""
    s = diff * diff
    return (s[..., 0] + s[..., 1]) + s[..., 2]


def fps_l1(points: torch.Tensor, k: int) -> torch.Tensor:
    """Farthest point sampling of each tile: (T, P, 3) -> (T, k) int64, from index 0."""
    t = points.shape[0]
    rows = torch.arange(t, device=points.device)
    dmin = torch.full(points.shape[:2], FAR, dtype=torch.float32, device=points.device)
    last = torch.zeros(t, dtype=torch.int64, device=points.device)
    picked = []
    for _ in range(k):
        picked.append(last)
        dmin = torch.minimum(dmin, l1(points - points[rows, last][:, None, :]))
        last = torch.argmax(dmin, dim=1)
    return torch.stack(picked, dim=1)


def first_k_in_range(d: torch.Tensor, limit: float, nsample: int) -> tuple:
    """Per row of d (..., M, P): the first nsample columns with d <= limit.

    Returns (idx (..., M, nsample) int64, mask bool); empty slots repeat the
    first hit, a row without one holds index 0.
    """
    hit = d <= float(np.float32(limit))
    count = hit.sum(dim=-1, keepdim=True)
    # columns of the hits in index order: sort (not hit, column) ascending
    cols = torch.arange(d.shape[-1], device=d.device)
    key = torch.where(hit, cols, d.shape[-1] + cols)
    first = torch.sort(key, dim=-1).values[..., :nsample]
    mask = torch.arange(nsample, device=d.device) < count
    first = torch.where(first >= d.shape[-1], 0, first)
    idx = torch.where(mask, first, first[..., :1])
    return idx, mask


def preprocess(points: torch.Tensor, cfg: dict) -> list[dict]:
    """Every SA stage's centroids and neighbourhoods of a batch (B, N, 3).

    Each stage: centroid_xyz (B, M, 3), idx (B, M, nsample) int64 global
    point indices, mask (B, M, nsample), and `scanned`, the points the
    lattice query's tile walk reads (a row stops at its nsample-th hit).
    """
    xyz = points[..., :3]
    stages = []
    for sa in cfg["sa"]:
        b, n, _ = xyz.shape
        depth = clamp_depth(n, sa["n_centroids"], cfg["msp_depth"])
        t = 1 << depth
        p, k = n // t, sa["n_centroids"] // t
        tiles = median_partition(xyz, depth).reshape(b * t, p)
        coords = _gather_rows(xyz, tiles.reshape(b, t * p)).reshape(b * t, p, 3)
        local_c = fps_l1(coords, k)
        cxyz = torch.take_along_dim(coords, local_c[..., None], dim=1)  # (bt, k, 3)
        d = l1(cxyz[:, :, None, :] - coords[:, None, :, :])  # (bt, k, p)
        lidx, mask = first_k_in_range(d, sa["radius"] * LATTICE_RANGE_FACTOR, sa["nsample"])
        gidx = torch.take_along_dim(tiles[:, None, :], lidx, dim=2)
        scanned = torch.where(mask[..., -1], lidx[..., -1] + 1, p).sum()
        m = t * k
        stages.append({
            "centroid_xyz": cxyz.reshape(b, m, 3),
            "idx": gidx.reshape(b, m, sa["nsample"]),
            "mask": mask.reshape(b, m, sa["nsample"]),
            "scanned": int(scanned),
            "tiles": (b * t, p, k),
        })
        xyz = cxyz.reshape(b, m, 3)
    return stages


def knn3(queries: torch.Tensor, points: torch.Tensor) -> tuple:
    """3 nearest points (squared L2) of each query: (B, Q, 3), (B, P, 3) -> idx, dist (B, Q, 3)."""
    d = sq_l2(queries[:, :, None, :] - points[:, None, :, :])
    idxs, dists = [], []
    for _ in range(3):
        j = torch.argmin(d, dim=-1, keepdim=True)
        dists.append(torch.take_along_dim(d, j, dim=-1))
        idxs.append(j)
        d = d.scatter(-1, j, float("inf"))
    return torch.cat(idxs, dim=-1), torch.cat(dists, dim=-1)


def quantize(x: torch.Tensor, bits: int) -> tuple:
    """Symmetric per-tensor quantization: (integer values as float64, float32 scale)."""
    qmax = (1 << (bits - 1)) - 1
    scale = torch.clamp(x.abs().amax(), min=1e-12) / torch.tensor(qmax, dtype=x.dtype,
                                                                 device=x.device)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.float64), scale


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, bits: int | None):
    """y = x @ w + b in float32, or through the exact integer product under SC."""
    if bits is None:
        y = _matmul_fp32(x, w)
    else:
        lead = x.shape[:-1]
        xq, sx = quantize(x.reshape(-1, x.shape[-1]), bits)
        wq, sw = quantize(w, bits)
        prod = torch.matmul(xq, wq).to(torch.float32)  # exact integers, rounded once
        y = (prod * (sx * sw)).reshape(*lead, w.shape[-1])
    return y if b is None else y + b


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * g + b over the last dim, statistics in float32."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def mlp(x, params: dict, prefix: str, n_layers: int, bits, *, norm: bool = True,
        final_act: bool = True):
    """The stack `prefix`.layers.{i}: linear, LayerNorm (if norm), ReLU (not after the
    last layer when final_act is False)."""
    for i in range(n_layers):
        p = f"{prefix}.layers.{i}"
        x = linear(x, params[f"{p}.lin.w"], params.get(f"{p}.lin.b"), bits)
        if norm:
            x = layer_norm(x, params[f"{p}.ln.g"], params[f"{p}.ln.b"])
        if final_act or i < n_layers - 1:
            x = torch.relu(x)
    return x


def masked_maxpool(grouped: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the neighbour axis of the real slots; 0 where a centroid has none."""
    far = torch.tensor(-FAR, dtype=grouped.dtype, device=grouped.device)
    out = torch.where(mask[..., None], grouped, far).amax(dim=-2)
    return torch.where(mask.any(dim=-1)[..., None], out, torch.zeros_like(out))


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Name -> shape of every weight of the configuration, in a fixed order.

    The names follow one scheme: `sa.{i}`, then `global_mlp` (cls) or
    `fp.{i}` (seg), then `head`, each `.layers.{j}.lin.{w,b}` and (but the
    head) `.layers.{j}.ln.{g,b}`; w is (d_in, d_out), y = x @ w.
    """
    shapes: dict[str, tuple] = {}

    def stack(prefix, channels, norm=True):
        for j, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            shapes[f"{prefix}.layers.{j}.lin.w"] = (cin, cout)
            shapes[f"{prefix}.layers.{j}.lin.b"] = (cout,)
            if norm:
                shapes[f"{prefix}.layers.{j}.ln.g"] = (cout,)
                shapes[f"{prefix}.layers.{j}.ln.b"] = (cout,)

    c_in = 3 + cfg["in_features"]
    for i, sa in enumerate(cfg["sa"]):
        stack(f"sa.{i}", [c_in, *sa["mlp"]])
        c_in = sa["mlp"][-1] + 3
    sa_out = cfg["sa"][-1]["mlp"][-1]
    if cfg["task"] == "cls":
        stack("global_mlp", [sa_out + 3, *cfg["global_mlp"]])
        c_head = cfg["global_mlp"][-1]
    else:
        skips = [3 + cfg["in_features"]] + [sa["mlp"][-1] for sa in cfg["sa"][:-1]]
        c_coarse = sa_out
        for i, skip_c in enumerate(reversed(skips)):
            cout = cfg["fp_mlp"][min(i, len(cfg["fp_mlp"]) - 1)]
            stack(f"fp.{i}", [c_coarse + skip_c, cout, cout])
            c_coarse = cout
        c_head = c_coarse
    stack("head", [c_head, *cfg["head"], cfg["n_classes"]], norm=False)
    return shapes


def forward(points: torch.Tensor, params: dict, cfg: dict, quant: str) -> torch.Tensor:
    """Logits of a batch (B, N, 3): (B, n_classes) for cls, (B, N, n_classes) for seg."""
    bits = QUANT_BITS[quant]
    with torch.no_grad():
        stages = preprocess(points, cfg)
        xyz = points[..., :3]
        levels = [(xyz, None)]
        for i, (sa, st) in enumerate(zip(cfg["sa"], stages)):
            lx, lf = levels[-1]
            x = lx if lf is None else torch.cat([lx, lf], dim=-1)
            feats = mlp(x, params, f"sa.{i}", len(sa["mlp"]), bits)
            pooled = masked_maxpool(_gather_rows(feats, st["idx"]), st["mask"])
            levels.append((st["centroid_xyz"], pooled))
        if cfg["task"] == "cls":
            x = torch.cat(levels[-1], dim=-1)
            x = mlp(x, params, "global_mlp", len(cfg["global_mlp"]), bits).amax(dim=1)
            return mlp(x, params, "head", len(cfg["head"]) + 1, bits, norm=False,
                       final_act=False)
        coarse_xyz, coarse_f = levels[-1]
        n_fp = len(cfg["sa"])
        for i in range(n_fp):
            fine_xyz, fine_f = levels[n_fp - 1 - i]
            idx, dist = knn3(fine_xyz, coarse_xyz)
            w = 1.0 / (dist + 1e-8)
            w = w / w.sum(dim=-1, keepdim=True)
            interp = None
            for j in range(3):
                term = _gather_rows(coarse_f, idx[..., j]) * w[..., j:j + 1]
                interp = term if interp is None else interp + term
            skip = fine_xyz if fine_f is None else fine_f
            coarse_f = mlp(torch.cat([interp, skip], dim=-1), params, f"fp.{i}", 2, bits)
            coarse_xyz = fine_xyz
        return mlp(coarse_f, params, "head", len(cfg["head"]) + 1, bits, norm=False,
                   final_act=False)


def fit_cloud(cloud: np.ndarray, bucket: int) -> np.ndarray:
    """A ragged (n, 3) cloud fitted to `bucket` rows: strided down, or its last point repeated."""
    n = cloud.shape[0]
    if n > bucket:
        return cloud[np.linspace(0, n - 1, bucket).round().astype(np.int64)]
    if n < bucket:
        return np.concatenate([cloud, np.repeat(cloud[-1:], bucket - n, axis=0)], axis=0)
    return cloud


def back_to_points(logits: np.ndarray, n: int, bucket: int) -> np.ndarray:
    """Per-point logits of a fitted row mapped back to the cloud's n points.

    A padded cloud keeps its first n rows; a strided one gives each point
    the row of its nearest kept point (the earlier one on ties).
    """
    if n <= bucket:
        return logits[:n]
    kept = np.linspace(0, n - 1, bucket).round().astype(np.int64)
    pts = np.arange(n)
    right = np.clip(np.searchsorted(kept, pts, side="left"), 0, bucket - 1)
    left = np.clip(right - 1, 0, bucket - 1)
    take_left = (pts - kept[left]) <= (kept[right] - pts)
    return logits[np.where(take_left, left, right)]
