"""internvl2-2b [vlm] — arXiv:2404.16821 (hf tier).

LM backbone (InternLM2-1.8B): 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The InternViT frontend is a stub, as in the reference:
callers give precomputed patch embeddings (B, n_patches, d_model), and a
learned connector projection (`patch_proj`) stands in for the mlp1 bridge.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    n_patches=256,
    rope_theta=1_000_000.0,
    act="silu",
    mlp_kind="glu",
    use_bias=False,
    loss_chunk=1024,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 64, 8 patches, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, n_patches=8, dtype_str="float32",
        attn_block=16, loss_chunk=32,
    )
