"""PointNet++ (PointNet2) — the paper's evaluation model — with PC2IM preprocessing.

Set-abstraction (SA) stages: sample centroids (FPS), query neighbours, learn
per-point features (MLP), max-pool per neighbourhood.  Ported so far: the
classification task with pc2im preprocessing (MSP + L1 FPS + lattice query)
and delayed aggregation (C5), in float or under the SC W16A16/W8A8 policies.

Delayed aggregation feeds *absolute* coords + features through the per-point
MLP and aggregates afterwards (Mesorasi [8], which the paper adopts).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
from torch import nn

from repro_torch.core import grouping as G
from repro_torch.core.engine import EngineConfig, clamp_depth, get_engine
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
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
    """Raise for the parts of the config this package does not run yet."""
    if cfg.task != "cls":
        raise ValueError(f"task {cfg.task!r} is not ported; only 'cls' runs here")
    if cfg.preproc != "pc2im":
        raise ValueError(f"preproc {cfg.preproc!r} is not ported; only 'pc2im' runs here")
    if cfg.aggregation != "delayed":
        raise ValueError(
            f"aggregation {cfg.aggregation!r} is not ported; only 'delayed' runs here"
        )


class PointNet2Params(nn.Module):
    """The weights of a cls PointNet2: one MLP per SA stage, the global MLP, the head.

    Mirrors the reference's parameter tree: `sa[i]`, `global_mlp` (the tree's
    "global") and `head`, each holding `layers[j].lin.{w,b}` and
    `layers[j].ln.{g,b}`.
    """

    def __init__(self, cfg: PointNet2Config, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        check_ported(cfg)
        kw = dict(generator=generator, device=device)
        c_in = 3 + cfg.in_features
        stages = []
        for sa in cfg.sa:
            stages.append(MLP([c_in] + list(sa.mlp), **kw))
            c_in = sa.mlp[-1] + 3  # next stage consumes features + xyz
        self.sa = nn.ModuleList(stages)
        self.global_mlp = MLP([cfg.sa[-1].mlp[-1] + 3] + list(cfg.global_mlp), **kw)
        self.head = MLP(
            [cfg.global_mlp[-1]] + list(cfg.head) + [cfg.n_classes], norm=False, **kw
        )


def init_params(cfg: PointNet2Config, generator: torch.Generator | None = None,
                device=None) -> PointNet2Params:
    """Fresh parameters: drawn on the CPU from `generator`, then moved to `device`."""
    return PointNet2Params(cfg, generator=generator, device=device)


def stage_engine(cfg: PointNet2Config, sa: SAConfig, n_points: int,
                 policy: ExecutionPolicy | None = None):
    """Batched PreprocessEngine for one SA stage (cached per distinct config).

    The policy's backend is part of the engine identity, so preprocessing
    and the SC feature path run under the same backend decision.
    """
    policy = resolve_policy(cfg, policy)
    check_ported(cfg)
    return get_engine(EngineConfig(
        pipeline="pc2im",
        n_centroids=sa.n_centroids,
        radius=sa.radius,
        nsample=sa.nsample,
        depth=clamp_depth(n_points, sa.n_centroids, cfg.msp_depth),
        backend=policy.backend,
    ))


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

    `preproc` is `preprocess_stage`'s output.  Returns cls logits (B, n_classes).
    """
    policy = resolve_policy(cfg, policy)
    check_ported(cfg)
    xyz = points[..., :3]
    feats = points[..., 3:] if cfg.in_features else None
    for mlp, res in zip(params.sa, preproc):
        xyz, feats = _sa_stage(mlp, xyz, feats, res, policy)
    x = torch.cat([xyz, feats], dim=-1)  # (B, M, C)
    x = params.global_mlp(x, policy=policy)
    x = x.amax(dim=1)  # global max pool per cloud
    return params.head(x, final_act=False, policy=policy)


def _sa_stage(mlp: MLP, xyz, feats, res, policy):
    """One batched delayed-aggregation SA stage.  xyz (B, N, 3), feats (B, N, C) | None.

    C5: per-POINT MLP on [abs-xyz, feats] over the whole batch, then gather
    each centroid's neighbours and masked max-pool.
    """
    x = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
    pointwise = mlp(x, policy=policy)  # (B, N, C')
    grouped = G.group_features(pointwise, res.neighbors)  # (B, M, S, C')
    return res.centroid_xyz, G.masked_maxpool(grouped, res.neighbors.mask)


def forward(params: PointNet2Params, cfg: PointNet2Config, points: torch.Tensor,
            policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """Batched forward.  points: (B, N, 3+F) -> logits (B, n_classes).

    Literally feature_stage(preprocess_stage(...)); the policy is resolved
    here, once, for both halves.
    """
    policy = resolve_policy(cfg, policy)
    return feature_stage(params, cfg, points, preprocess_stage(cfg, points, policy), policy)
