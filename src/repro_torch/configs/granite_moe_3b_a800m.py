"""granite-moe-3b-a800m [moe] — hf:ibm-granite/granite-3.0-3b-a800m-base (hf tier).

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts top-8
(fine-grained experts; the inline assignment spec takes precedence over the
bracketed 32e description).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    capacity_factor=1.25,
    rope_theta=10000.0,
    act="silu",
    mlp_kind="glu",
    use_bias=False,
    tie_embeddings=True,
    loss_chunk=2048,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 64, 8 experts top-2, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab_size=256, n_experts=8, top_k=2, dtype_str="float32",
        attn_block=16, loss_chunk=32,
    )
