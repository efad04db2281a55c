"""Abstract inputs of every (arch x shape) cell of the LM dry run: batches, decode
states, parameters and optimizer state as meta tensors, and the cell's model
FLOPs.

The JAX package's `launch/shapes.py`.  Tensors on `torch.device("meta")`
stand in for `jax.ShapeDtypeStruct`: they carry shape and dtype and no
memory, and the port's ops run on them without computing a value.  The
shapes:

    train_4k     seq_len=4096    global_batch=256   (training step)
    prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
    decode_32k   seq_len=32768   global_batch=128   (one token + 32k cache)
    long_500k    seq_len=524288  global_batch=1     (long-context decode)

long_500k applies only to the sub-quadratic archs (mamba2, recurrentgemma,
gemma3); the full-attention archs skip it with the reference's reason.  The
[audio] and [vlm] frontends are stubs: the batch carries their frame or
patch embeddings.  Parameters and optimizer state come in the reference's
layout (the layers stacked, `params.lm_param_tree`), which the sharding
rules read.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# archs allowed to run long_500k (sub-quadratic / bounded-window decode)
LONG_OK = {"mamba2-1.3b", "recurrentgemma-2b", "gemma3-12b"}


def skip_reason(arch: str, shape: str) -> str | None:
    """Why the cell (arch, shape) is skipped, or None where it runs."""
    if shape == "long_500k" and arch not in LONG_OK:
        return "full-attention arch: long_500k skipped per assignment rule"
    return None


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_batch_specs(cfg: ModelConfig, batch: int, seq: int, *, labels: bool = True) -> dict:
    """{tokens (batch, seq) int32[, labels]} as meta tensors."""
    d = {"tokens": _sds((batch, seq), torch.int32)}
    if labels:
        d["labels"] = _sds((batch, seq), torch.int32)
    return d


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Abstract batch for train_loss / prefill / decode_step (decode: the one
    token; its state comes from `decode_state_specs`)."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    kind = info["kind"]
    if kind == "decode":
        return {"token": _sds((b, 1), torch.int32)}

    if cfg.family == "encdec":
        d = token_batch_specs(cfg, b, s, labels=(kind == "train"))
        d["enc_embeds"] = _sds((b, s, cfg.d_model), cfg.dtype)
        return d
    if cfg.family == "vlm":
        s_text = s - cfg.n_patches
        d = {"tokens": _sds((b, s_text), torch.int32)}
        if kind == "train":
            d["labels"] = _sds((b, s_text), torch.int32)
        d["patch_embeds"] = _sds((b, cfg.n_patches, cfg.d_model), cfg.dtype)
        return d
    return token_batch_specs(cfg, b, s, labels=(kind == "train"))


def decode_state_specs(cfg: ModelConfig, shape_name: str):
    """The family's decode state for the shape's batch and length, on meta."""
    from repro_torch.models.families import get_family_api

    info = SHAPES[shape_name]
    return get_family_api(cfg)["init_decode_state"](cfg, info["batch"], info["seq"],
                                                     device=META)


def abstract_module(cfg: ModelConfig) -> torch.nn.Module:
    """The family's parameter module on meta: nothing drawn, nothing allocated."""
    from repro_torch.models.families import get_family_api

    return get_family_api(cfg)["init"](cfg, device=META)


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's parameter tree (layers stacked) of meta tensors."""
    from repro_torch.params import lm_param_tree

    return lm_param_tree(abstract_module(cfg), device=META)


def abstract_opt_state(params_shape):
    """AdamW's state for a parameter tree, on meta (`adamw_init_from_shapes`)."""
    return adamw_init_from_shapes(params_shape)


def adamw_init_from_shapes(params_shape, device=META):
    """The reference's `adamw_init` over a tree of tensors' shapes: AdamWState(step
    int32, mu and nu float32 like each leaf, master a float32 copy where any leaf
    is not float32), the tree's structure kept, on `device` (meta by default)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.sharding.policy import map_with_path

    def f32(path, leaf):
        return torch.zeros(leaf.shape, dtype=torch.float32, device=device)

    leaves = []
    map_with_path(params_shape, lambda path, leaf: leaves.append(leaf))
    keep_master = any(p.dtype != torch.float32 for p in leaves)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=map_with_path(params_shape, f32), nu=map_with_path(params_shape, f32),
                      master=map_with_path(params_shape, f32) if keep_master else None)


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """MODEL_FLOPS: 6*N*D for train (N = params excl. embeddings read-only
    share; we use total non-embedding params + lm_head), 2*N per generated
    token for decode, 2*N*D for prefill; attention flops added explicitly."""
    info = SHAPES[shape_name]
    return model_flops_at(cfg, info["kind"], info["batch"], info["seq"])


def model_flops_at(cfg: ModelConfig, kind: str, b: int, s: int) -> float:
    """`model_flops` of a step of `kind` ("train", "prefill" or "decode") over b
    sequences of s positions (decode: one token against s cached)."""
    n = cfg.param_count()
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_active = n - emb
    if cfg.family == "moe":
        # active experts only
        dense_share = cfg.n_experts and (cfg.top_k / cfg.n_experts)
        moe_params = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        n_active = n_active - moe_params + moe_params * dense_share
    # attention context flops per token ~ 2*2*Hq*dh*ctx (qk + pv)
    pat = cfg.pattern_for_layers()
    heads_flops = 0.0
    for t in pat:
        if t == "recurrent":
            continue
        ctx = s if t == "global" else min(s, cfg.window or s)
        if kind in ("train", "prefill"):
            ctx_eff = ctx / 2 if t == "global" else ctx  # causal average
            heads_flops += 4 * cfg.n_heads * cfg.head_dim * ctx_eff
        else:
            heads_flops += 4 * cfg.n_heads * cfg.head_dim * ctx
    # encoder attention context (whisper): params already in n_active, but the
    # non-causal full-context score/value flops are not in `heads_flops`
    # (which walks the decoder pattern); cross-attention adds another S ctx.
    enc_flops_per_token = 0.0
    if cfg.encoder_layers:
        hh, dh = cfg.n_heads, cfg.head_dim
        enc_flops_per_token = cfg.encoder_layers * 4 * hh * dh * s  # self (full)
        enc_flops_per_token += cfg.n_layers * 4 * hh * dh * s  # decoder cross
    # lm head
    head = 2 * cfg.d_model * cfg.vocab_size
    if kind == "train":
        per_token = 6 * n_active + 3 * heads_flops + 3 * head + 3 * enc_flops_per_token
        return b * s * per_token
    if kind == "prefill":
        per_token = 2 * n_active + heads_flops + enc_flops_per_token
        return b * s * per_token + b * head
    per_token = 2 * n_active + heads_flops + head
    return b * per_token
