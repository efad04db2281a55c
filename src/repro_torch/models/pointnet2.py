"""PointNet++ (PointNet2) — the paper's evaluation model — with PC2IM preprocessing.

Set-abstraction (SA) stages: sample centroids (FPS), query neighbours, learn
per-point features (MLP), max-pool per neighbourhood.  Feature-propagation
(FP) stages (segmentation): 3-NN inverse-distance interpolation + unit MLPs.
Classification and segmentation, in float or under the SC W16A16/W8A8
policies, and the training loss (`loss_fn`).

The paper's switches, all config-selectable:
  preproc    : "baseline1" (global L2 FPS + ball)  |  "baseline2" (grid tiles)
               | "pc2im" (MSP + L1 FPS + lattice query)
  aggregation: "standard" (group->mlp->pool) | "delayed" (mlp->group->pool, C5)

Standard SA feeds the MLP relative coordinates (neighbour - centroid),
which cannot be precomputed per point; delayed aggregation feeds *absolute*
coords + features through the per-point MLP and aggregates afterwards
(Mesorasi [8], which the paper adopts).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
from torch import nn

from repro_torch.core import grouping as G
from repro_torch.core import query as Q
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import EngineConfig, clamp_depth, get_engine
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.kernels.knn3.ops import knn3
from repro_torch.models.nn import MLP


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """One set-abstraction stage: centroids, query radius, neighbours, MLP widths."""

    n_centroids: int
    radius: float
    nsample: int
    mlp: tuple[int, ...]  # hidden/out channels (input inferred)


@dataclasses.dataclass(frozen=True)
class PointNet2Config:
    """PointNet2 architecture and preprocessing switches (as in the reference)."""

    name: str = "pointnet2"
    task: Literal["cls", "seg"] = "cls"
    n_points: int = 1024
    n_classes: int = 8
    in_features: int = 0  # extra per-point features beyond xyz
    sa: tuple[SAConfig, ...] = (
        SAConfig(256, 0.2, 32, (64, 64, 128)),
        SAConfig(64, 0.4, 32, (128, 128, 256)),
    )
    global_mlp: tuple[int, ...] = (256, 512, 1024)  # final global SA (cls)
    fp_mlp: tuple[int, ...] = (256, 128)  # per-FP-stage out channels (seg)
    head: tuple[int, ...] = (512, 256)
    preproc: Literal["baseline1", "baseline2", "pc2im"] = "pc2im"
    aggregation: Literal["standard", "delayed"] = "delayed"
    quant: Literal["none", "sc_w16a16", "sc_w8a8"] = "none"
    msp_depth: int = 2  # MSP tiles = 2^depth (pc2im preproc)
    preproc_backend: str = "auto"  # kernel registry backend for preprocessing

    @property
    def family(self) -> str:
        """Model family name shared with the reference's registry."""
        return "pointcloud"


def check_ported(cfg: PointNet2Config) -> None:
    """Raise for the parts of the config this package does not run yet.

    Every preproc x aggregation corner runs; an unknown preproc is refused
    by the engine, an unknown aggregation by the SA stage.
    """
    if cfg.task not in ("cls", "seg"):
        raise ValueError(f"task {cfg.task!r} is not ported; only 'cls' and 'seg' run here")


class PointNet2Params(nn.Module):
    """The weights of a PointNet2: one MLP per SA stage, then the task's own.

    Mirrors the reference's parameter tree: `sa[i]`, then for cls
    `global_mlp` (the tree's "global") and `head`, for seg `fp[i]` (one MLP
    per FP stage, coarsest first) and `head`; each MLP holds
    `layers[j].lin.{w,b}` and `layers[j].ln.{g,b}`.  Weights are drawn on
    the CPU from `generator` and moved to `device`, the card by default.
    """

    def __init__(self, cfg: PointNet2Config, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        check_ported(cfg)
        kw = dict(generator=generator, device=resolve_device(device))
        c_in = 3 + cfg.in_features
        stages = []
        for sa in cfg.sa:
            stages.append(MLP([c_in] + list(sa.mlp), **kw))
            c_in = sa.mlp[-1] + 3  # next stage consumes features + xyz
        self.sa = nn.ModuleList(stages)
        sa_out = cfg.sa[-1].mlp[-1]
        if cfg.task == "cls":
            self.global_mlp = MLP([sa_out + 3] + list(cfg.global_mlp), **kw)
            c_head = cfg.global_mlp[-1]
        else:
            # FP stages walk back up the SA pyramid; each concatenates the
            # interpolated coarse features with the finer level's skip
            skips = [3 + cfg.in_features] + [sa.mlp[-1] for sa in cfg.sa[:-1]]
            c_coarse, fp = sa_out, []
            for i, skip_c in enumerate(reversed(skips)):
                cout = cfg.fp_mlp[min(i, len(cfg.fp_mlp) - 1)]
                fp.append(MLP([c_coarse + skip_c, cout, cout], **kw))
                c_coarse = cout
            self.fp = nn.ModuleList(fp)
            c_head = c_coarse
        self.head = MLP([c_head] + list(cfg.head) + [cfg.n_classes], norm=False, **kw)


def init_params(cfg: PointNet2Config, generator: torch.Generator | None = None,
                device=None) -> PointNet2Params:
    """Fresh parameters: drawn on the CPU from `generator`, then moved to `device`.

    `device` defaults to the card (raises without one); pass "cpu" for the CPU.
    """
    return PointNet2Params(cfg, generator=generator, device=device)


def stage_engine(cfg: PointNet2Config, sa: SAConfig, n_points: int,
                 policy: ExecutionPolicy | None = None):
    """Batched PreprocessEngine for one SA stage (cached per distinct config).

    The policy's backend is part of the engine identity, so preprocessing
    and the SC feature path run under the same backend decision.  pc2im's
    MSP depth is clamped to the stage's sizes; the baselines take the
    engine's defaults (baseline2: a 2^3 grid at twice the mean occupancy).
    """
    policy = resolve_policy(cfg, policy)
    check_ported(cfg)
    kw = dict(pipeline=cfg.preproc, n_centroids=sa.n_centroids, radius=sa.radius,
              nsample=sa.nsample, backend=policy.backend)
    if cfg.preproc == "pc2im":
        kw["depth"] = clamp_depth(n_points, sa.n_centroids, cfg.msp_depth)
    return get_engine(EngineConfig(**kw))


def preprocess_stage(cfg: PointNet2Config, points: torch.Tensor,
                     policy: ExecutionPolicy | None = None) -> tuple:
    """Params-free preprocessing half: points (B, N, 3+F) -> one PreprocessResult per SA stage.

    Stage i samples from stage i-1's centroid_xyz, never from learned
    features, so this half reads only coordinates.
    """
    policy = resolve_policy(cfg, policy)
    xyz = points[..., :3]
    results = []
    for sa_cfg in cfg.sa:
        res = stage_engine(cfg, sa_cfg, xyz.shape[-2], policy)(xyz)
        results.append(res)
        xyz = res.centroid_xyz
    return tuple(results)


def feature_stage(params: PointNet2Params, cfg: PointNet2Config, points: torch.Tensor,
                  preproc: tuple, policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """Feature half: per-point MLPs + aggregation over precomputed neighbourhoods.

    `preproc` is `preprocess_stage`'s output.  Returns cls logits
    (B, n_classes), or seg logits (B, N, n_classes) after the FP stages.
    """
    policy = resolve_policy(cfg, policy)
    check_ported(cfg)
    xyz = points[..., :3]
    feats = points[..., 3:] if cfg.in_features else None
    levels = [(xyz, feats)]
    for mlp, res in zip(params.sa, preproc):
        levels.append(_sa_stage(cfg.aggregation, mlp, *levels[-1], res, policy))

    if cfg.task == "cls":
        x = torch.cat(levels[-1], dim=-1)  # (B, M, 3 + C)
        x = params.global_mlp(x, policy=policy)
        x = x.amax(dim=1)  # global max pool per cloud
        return params.head(x, final_act=False, policy=policy)

    # segmentation: FP stages walk the pyramid back from coarse to fine.
    # Skips: intermediate levels contribute their SA features, the finest
    # level its raw xyz (plus input features).
    coarse_xyz, coarse_f = levels[-1]
    n_fp = len(params.fp)
    for i, mlp in enumerate(params.fp):
        fine_xyz, fine_f = levels[n_fp - 1 - i]
        idx, dist = knn3(fine_xyz, coarse_xyz, k=3, metric="l2",
                         backend=policy.resolved_backend())
        w = Q.three_nn_interpolate_weights(dist)
        interp = G.interpolate_features(coarse_f, idx, w)  # (B, Nf, Cc)
        if i == n_fp - 1:  # finest level: raw inputs as skip
            skip = fine_xyz if fine_f is None else torch.cat([fine_xyz, fine_f], dim=-1)
        else:
            skip = fine_f
        coarse_f = mlp(torch.cat([interp, skip], dim=-1), policy=policy)
        coarse_xyz = fine_xyz
    return params.head(coarse_f, final_act=False, policy=policy)


def _sa_stage(aggregation: str, mlp: MLP, xyz, feats, res, policy):
    """One batched SA stage.  xyz (B, N, 3), feats (B, N, C) | None.

    delayed (C5): per-POINT MLP on [abs-xyz, feats] over the whole batch,
    then gather each centroid's neighbours and masked max-pool.  standard:
    gather [neighbour - centroid xyz, neighbour feats] (B, M, S, 3 + C), the
    MLP over every grouped row, then the masked max-pool.  Under SC the
    activation scale spans the whole grouped tensor, masked slots included,
    as in the reference.
    """
    nbrs = res.neighbors
    if aggregation == "delayed":
        x = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        return res.centroid_xyz, G.aggregate_delayed(x, nbrs, lambda t: mlp(t, policy=policy))
    if aggregation != "standard":
        raise ValueError(f"aggregation must be 'standard' or 'delayed', got {aggregation!r}")
    grouped = G.group_relative_coords(xyz, res.centroid_xyz, nbrs)  # (B, M, S, 3)
    if feats is not None:
        grouped = torch.cat([grouped, G.group_features(feats, nbrs)], dim=-1)
    return res.centroid_xyz, G.masked_maxpool(mlp(grouped, policy=policy), nbrs.mask)


def forward(params: PointNet2Params, cfg: PointNet2Config, points: torch.Tensor,
            policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """Batched forward.  points: (B, N, 3+F) -> logits (B, n_classes) | seg (B, N, n_classes).

    Literally feature_stage(preprocess_stage(...)); the policy is resolved
    here, once, for both halves.
    """
    policy = resolve_policy(cfg, policy)
    return feature_stage(params, cfg, points, preprocess_stage(cfg, points, policy), policy)


def loss_fn(params: PointNet2Params, cfg: PointNet2Config, points: torch.Tensor,
            labels: torch.Tensor, policy: ExecutionPolicy | None = None) -> tuple:
    """Mean negative log-likelihood and (loss, accuracy) metrics, as the reference computes them.

    labels: (B,) class ids for cls, (B, N) per-point ids for seg.  Returns
    (nll, {"loss": nll, "accuracy": acc}); the accuracy is the share of
    argmax predictions equal to the label, ties going to the first index.
    Autograd flows through the forward as it runs.
    """
    logits = forward(params, cfg, points, policy=policy)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.to(torch.int64)
    nll = -torch.take_along_dim(logp, labels[..., None], dim=-1).mean()
    acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
    return nll, {"loss": nll, "accuracy": acc}
