"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048 (attention-free) d_ff=0 vocab=50280, ssm_state=128,
headdim 64, expand 2 (d_inner 4096 -> 64 heads), conv width 4.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,  # attention-free; SSD heads derive from d_inner/headdim
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    loss_chunk=2048,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-1.3b",
)


def smoke_config() -> ModelConfig:
    """Reduced config for tests: 2 layers, d_model 64, state 16, chunk 8, float32."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, ssm_state=16, ssm_headdim=16,
        ssm_chunk=8, vocab_size=256, dtype_str="float32", loss_chunk=32,
    )
