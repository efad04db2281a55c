"""gemma3-12b [dense] — hf:google/gemma-3-* (unverified tier).

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5:1 local:global
sliding-window pattern (window 1024), 128k context, head_dim 256, tied
embeddings (gemma family convention).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    act="gelu",
    mlp_kind="glu",
    tie_embeddings=True,
    use_bias=False,
    loss_chunk=512,
    source="hf:google/gemma-3-12b-pt",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: one group of six layers, d_model 64, window 8, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, window=8, dtype_str="float32",
        attn_block=16, loss_chunk=32,
    )
