"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b (unverified tier).

24L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=5632 vocab=100352.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    act="silu",
    mlp_kind="glu",
    use_bias=False,
    loss_chunk=1024,
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 64, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=176,
        vocab_size=256, dtype_str="float32", attn_block=16, loss_chunk=32,
    )
