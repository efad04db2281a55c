"""command-r-plus-104b [dense] — hf:CohereForAI/c4ai-command-r-plus (unverified).

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 — GQA, no-bias,
tied embeddings (Cohere convention).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
    act="silu",
    mlp_kind="glu",
    use_bias=False,
    tie_embeddings=True,
    loss_chunk=512,
    source="hf:CohereForAI/c4ai-command-r-plus",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 96, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=12, n_kv_heads=2, d_ff=256,
        vocab_size=256, dtype_str="float32", attn_block=16, loss_chunk=32,
    )
