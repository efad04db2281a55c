"""dbrx-132b [moe] — hf:databricks/dbrx-base (unverified tier).

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16 experts
top-4 (fine-grained).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    capacity_factor=1.25,
    rope_theta=500_000.0,
    act="silu",
    mlp_kind="glu",
    use_bias=False,
    loss_chunk=1024,
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 64, 4 experts top-2, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, n_experts=4, top_k=2, dtype_str="float32",
        attn_block=16, loss_chunk=32,
    )
