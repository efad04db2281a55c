"""PointNet2 semantic segmentation (S3DIS/SemanticKITTI-style 4k points, the paper's (s) model)."""

import dataclasses

from repro_torch.models.pointnet2 import PointNet2Config, SAConfig

CONFIG = PointNet2Config(
    name="pointnet2-seg",
    task="seg",
    n_points=4096,
    n_classes=8,
    sa=(
        SAConfig(1024, 0.2, 32, (64, 64, 128)),
        SAConfig(256, 0.4, 32, (128, 128, 256)),
    ),
    fp_mlp=(256, 128),
    head=(128,),
    preproc="pc2im",
    aggregation="delayed",
    msp_depth=3,
)


def smoke_config() -> PointNet2Config:
    """Reduced config for tests: N=256, narrow MLPs, same structure."""
    return dataclasses.replace(
        CONFIG,
        n_points=256,
        sa=(SAConfig(64, 0.3, 16, (32, 32, 64)), SAConfig(16, 0.6, 16, (64, 64, 128))),
        fp_mlp=(64, 64),
        head=(64,),
        msp_depth=2,
    )
