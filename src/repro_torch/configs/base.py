"""Unified LM configuration (`ModelConfig`) and the architecture ids of the JAX package.

A copy, field for field, of the reference's `configs/base.py`: the same
defaults, `head_dim`, `pattern_for_layers` and the analytic `param_count`.
`dtype` gives a `torch.dtype`.  The port serves every config of the
reference (`configs.get_config`); a name with no module raises `KeyError`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM architecture: widths, attention pattern, family extras, numerics."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # attention pattern: one entry per layer-in-group, cycled over the stack.
    # "global" = full causal; "local" = sliding window; "recurrent" = RG-LRU.
    layer_pattern: tuple[str, ...] = ("global",)
    window: int = 0  # sliding-window size for "local" layers
    rope_theta: float = 10000.0
    use_bias: bool = False
    act: str = "silu"
    mlp_kind: str = "glu"  # glu | dense
    norm_kind: str = "rms"  # rms | ln
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # RG-LRU (hybrid)
    lru_width: int = 0
    # encoder (whisper) / frontend stub (vlm, whisper)
    encoder_layers: int = 0
    n_patches: int = 256  # vlm: image-patch positions in the sequence
    # numerics / execution
    dtype_str: str = "bfloat16"
    attn_block: int = 512
    loss_chunk: int = 2048  # seq-chunked vocab-parallel cross entropy
    quant: str = "none"  # none | sc_w16a16 | sc_w8a8
    kv_quant: str = "none"  # none | int8 (KV caches)
    remat: str = "full"  # none | block | full
    # provenance
    source: str = ""

    @property
    def head_dim(self) -> int:
        """Width of one attention head: d_head, else d_model // n_heads."""
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' and activations' dtype (`dtype_str` as a torch.dtype)."""
        dt = getattr(torch, self.dtype_str, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: dtype_str={self.dtype_str!r} is not a torch dtype")
        return dt

    def pattern_for_layers(self) -> list[str]:
        """The slot type of every layer: layer_pattern cycled over n_layers."""
        pat = list(self.layer_pattern)
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the reference's formula."""
        d, dh = self.d_model, self.head_dim
        emb = self.vocab_size * d
        per_layer = 0.0
        counts = {"global": 0, "local": 0, "recurrent": 0}
        for t in self.pattern_for_layers():
            counts[t] += 1
        attn = (self.n_heads * dh + 2 * self.n_kv_heads * dh + self.n_heads * dh) * d
        if self.family == "moe":
            mlp = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
        elif self.mlp_kind == "glu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "ssm":
            din = self.ssm_expand * d
            heads = din // self.ssm_headdim
            ssm = d * (2 * din + 2 * self.ssm_state + heads) + din * d
            per_layer = ssm + mlp if self.d_ff else ssm
            total = emb + self.n_layers * per_layer
        elif self.family == "hybrid":
            w = self.lru_width or d
            rec = d * w * 3 + 2 * w  # in/gate/out projections + lru params
            total = emb + counts["recurrent"] * (rec + mlp) + (
                counts["global"] + counts["local"]
            ) * (attn + mlp)
        else:
            total = emb + self.n_layers * (attn + mlp)
        if self.encoder_layers:
            # encoder blocks + the decoder's cross-attention projections
            total += self.encoder_layers * (attn + mlp) + self.n_layers * attn
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return int(total)


# Every architecture id of the JAX package; `configs.get_config` serves each.
ARCH_IDS = [
    "stablelm-1.6b",
    "gemma3-12b",
    "command-r-plus-104b",
    "starcoder2-3b",
    "dbrx-132b",
    "granite-moe-3b-a800m",
    "mamba2-1.3b",
    "recurrentgemma-2b",
    "whisper-small",
    "internvl2-2b",
    "pointnet2-cls",
    "pointnet2-seg",
]
