"""PointNet2 classification (the paper's own model, ModelNet-style 1k points)."""

import dataclasses

from repro_torch.models.pointnet2 import PointNet2Config, SAConfig

CONFIG = PointNet2Config(
    name="pointnet2-cls",
    task="cls",
    n_points=1024,
    n_classes=8,
    sa=(
        SAConfig(256, 0.2, 32, (64, 64, 128)),
        SAConfig(64, 0.4, 32, (128, 128, 256)),
    ),
    global_mlp=(256, 512, 1024),
    head=(512, 256),
    preproc="pc2im",
    aggregation="delayed",
    msp_depth=2,
)


def smoke_config() -> PointNet2Config:
    """Reduced config for tests: N=256, narrow MLPs, same structure."""
    return dataclasses.replace(
        CONFIG,
        n_points=256,
        sa=(SAConfig(64, 0.3, 16, (32, 32, 64)), SAConfig(16, 0.6, 16, (64, 64, 128))),
        global_mlp=(128, 256),
        head=(128,),
        msp_depth=2,
    )
