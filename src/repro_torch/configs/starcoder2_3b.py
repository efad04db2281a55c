"""starcoder2-3b [dense] — arXiv:2402.19173 + hf:bigcode/starcoder2-3b.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE,
dense GELU MLP with bias (starcoder2 convention).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=100_000.0,
    act="gelu",
    mlp_kind="dense",
    use_bias=True,
    norm_kind="ln",
    loss_chunk=2048,
    source="arXiv:2402.19173; hf:bigcode/starcoder2-3b",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 96, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab_size=256, dtype_str="float32", attn_block=16, loss_chunk=32,
    )
