"""whisper-small [audio enc-dec] — arXiv:2212.04356 (unverified tier).

12L encoder + 12L decoder, d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865.  The conv audio frontend is a stub, as in the reference:
callers give precomputed frame embeddings (B, S_enc, d_model).  Absolute
sinusoidal positions (rope disabled), dense GELU MLPs with bias, LayerNorm.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rope_theta=0.0,  # absolute positions
    act="gelu",
    mlp_kind="dense",
    use_bias=True,
    norm_kind="ln",
    tie_embeddings=True,
    loss_chunk=2048,
    source="arXiv:2212.04356; hf:openai/whisper-small",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 + 2 layers, d_model 64, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, dtype_str="float32",
        attn_block=16, loss_chunk=32,
    )
