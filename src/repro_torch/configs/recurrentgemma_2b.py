"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin), hf tier.

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000 — RG-LRU +
local attention in a (recurrent, recurrent, local) 1:2 pattern, window 2048,
lru_width 2560, head_dim 256, tied embeddings.  26 = 8 full groups + 2
remainder recurrent layers.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("recurrent", "recurrent", "local"),
    window=2048,
    lru_width=2560,
    rope_theta=10000.0,
    act="gelu",
    mlp_kind="glu",
    tie_embeddings=True,
    use_bias=False,
    loss_chunk=512,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 5 layers (one group and two remainder layers),
    d_model 64, window 8, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, lru_width=64, window=8, vocab_size=256,
        dtype_str="float32", attn_block=16, loss_chunk=32,
    )
