"""Decoder-only transformer LM of the `dense` family: the module, its seeded
init, and serving (prefill and decode with stacked KV caches).

The JAX package's `models/transformer.py` for stablelm-1.6b, starcoder2-3b,
gemma3-12b and command-r-plus-104b.  The reference scans over groups of
`len(cfg.layer_pattern)` layers with each slot's parameters stacked
(n_groups, ...); here the layers are one `ModuleList` in order, layer i
being group i // g, slot i % g (`group_geometry`), which is how
`params.lm_from_jax_params` maps the stacked leaves.  Mixed local/global
patterns (gemma3's 5:1) give each slot its own attention config, so each
slot's sliding-window block pairs stay static.

Decode keeps, per slot, the caches of all groups stacked (n_groups, B,
S_eff, Hkv, Dh), as the reference's `DecodeState` does; a local slot's
cache holds only the last `window` positions, position p at slot p % S_eff.
Both steps are functional: they return a new state and leave the old one
as it was.  `cache_len` is a 0-d int32 tensor on the model's device and no
step reads anything back to the host, so a later change can capture decode
as a CUDA graph.

Not here: the training loss (`lm_loss`, `chunked_cross_entropy`) comes
with LM training, and the reference's `hint_residual` is a no-op without a
device mesh (ROADMAP.md queue A steps 3f and 3g).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models.layers import (
    AttnConfig,
    Attention,
    DenseMLP,
    GLUMLP,
    KVCache,
    QuantKVCache,
    RMSNorm,
    quantize_kv,
)
from repro_torch.models.nn import LayerNorm

NOT_PORTED_FAMILY = ("{name}: the {family!r} family is not ported yet (ROADMAP.md queue A "
                     "step 3); the port serves the dense LMs")


def check_dense(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless `cfg` is of the ported `dense` family."""
    if cfg.family != "dense":
        raise NotImplementedError(NOT_PORTED_FAMILY.format(name=cfg.name, family=cfg.family))


def attn_cfg_for(cfg: ModelConfig, slot_type: str) -> AttnConfig:
    """The causal attention config of one slot: local slots take the sliding window."""
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        window=cfg.window if slot_type == "local" else None,
        use_bias=cfg.use_bias,
    )


def group_geometry(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, layers a group): the layer pattern must divide the depth."""
    g = len(cfg.layer_pattern)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible by pattern {g}")
    return cfg.n_layers // g, g


def _norm(cfg: ModelConfig, device, dtype) -> nn.Module:
    if cfg.norm_kind == "ln":
        return LayerNorm(cfg.d_model, device=device, dtype=dtype)
    return RMSNorm(cfg.d_model, device=device, dtype=dtype)


class Block(nn.Module):
    """One pre-norm layer: h + attn(ln1 h), then h + mlp(ln2 h)."""

    def __init__(self, cfg: ModelConfig, slot_type: str, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dtype = cfg.dtype
        self.slot_type = slot_type
        self.ln1 = _norm(cfg, device, dtype)
        self.attn = Attention(attn_cfg_for(cfg, slot_type), generator=generator, device=device,
                              dtype=dtype)
        self.ln2 = _norm(cfg, device, dtype)
        mlp = GLUMLP if cfg.mlp_kind == "glu" else DenseMLP
        self.mlp = mlp(cfg.d_model, cfg.d_ff, bias=cfg.use_bias, act=cfg.act,
                       generator=generator, device=device, dtype=dtype)

    def forward(self, h: torch.Tensor, *, positions: torch.Tensor, attn_block: int,
                policy: ExecutionPolicy | None = None, **attn_kw):
        """(B, S, D) -> (h, aux); `attn_kw` go to `Attention.forward` (cache, write_idx,
        attend_len, decode_window, collect_kv), and aux is what it returns."""
        a, aux = self.attn(self.ln1(h), positions=positions, attn_block=attn_block,
                           policy=policy, **attn_kw)
        h = h + a
        h = h + self.mlp(self.ln2(h), policy=policy)
        return h, aux


class DenseLM(nn.Module):
    """The dense LM's parameters: `embed` (V, D), `blocks` (layer i = group i // g,
    slot i % g), `final_norm`, and `lm_head` (D, V) unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        check_dense(cfg)
        group_geometry(cfg)
        self.cfg = cfg
        dtype = cfg.dtype
        draw_on = None if generator is None else generator.device

        def normal(*shape):
            return torch.randn(*shape, generator=generator, device=draw_on)

        self.embed = nn.Parameter((normal(cfg.vocab_size, cfg.d_model) * 0.02).to(
            device=device, dtype=dtype))
        self.final_norm = _norm(cfg, device, dtype)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            (normal(cfg.d_model, cfg.vocab_size) / math.sqrt(cfg.d_model)).to(
                device=device, dtype=dtype))
        self.blocks = nn.ModuleList(
            Block(cfg, slot_type, generator=generator, device=device)
            for slot_type in cfg.pattern_for_layers())


def init_lm(cfg: ModelConfig, *, generator: torch.Generator | None = None,
            device=None) -> DenseLM:
    """Seeded parameters with the reference's distributions: embed N(0, 0.02^2),
    lm_head N(0, 1/d_model), every linear N(0, 1/d_in) with zero biases, norms
    at one (and zero).  Drawn on the generator's device (a CUDA generator
    draws a full-size model in place), in `cfg.dtype`, on the card unless
    `device` names another."""
    return DenseLM(cfg, generator=generator, device=resolve_device(device))


def embed_tokens(params: DenseLM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int token ids -> (B, S, D) rows of the embedding."""
    return F.embedding(tokens, params.embed)


def lm_head_weights(params: DenseLM, cfg: ModelConfig) -> torch.Tensor:
    """(D, V): the LM head, or the tied embedding transposed."""
    return params.embed.t() if cfg.tie_embeddings else params.lm_head


# ---------------------------------------------------------------------------
# Serving: prefill + decode with stacked caches
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per slot a KVCache or QuantKVCache of (n_groups, B, S_eff, Hkv, Dh), and the
    number of positions written so far (0-d int32, on the model's device)."""

    caches: tuple
    cache_len: torch.Tensor


def _s_eff(cfg: ModelConfig, slot_type: str, s_max: int) -> int:
    return min(s_max, cfg.window) if (slot_type == "local" and cfg.window) else s_max


def init_decode_state(cfg: ModelConfig, batch: int, s_max: int, *, device=None) -> DecodeState:
    """Empty caches for `batch` sequences of up to `s_max` positions (int8 with
    float32 scales under cfg.kv_quant="int8"), on the card unless `device`
    names another."""
    dev = resolve_device(device)
    n_groups, _ = group_geometry(cfg)
    caches = []
    for slot_type in cfg.layer_pattern:
        shape = (n_groups, batch, _s_eff(cfg, slot_type, s_max), cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant == "int8":
            sshape = shape[:-1] + (1,)
            caches.append(QuantKVCache(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev)))
        else:
            caches.append(KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                                  torch.zeros(shape, dtype=cfg.dtype, device=dev)))
    return DecodeState(caches=tuple(caches), cache_len=torch.zeros((), dtype=torch.int32,
                                                                   device=dev))


def prefill(params: DenseLM, cfg: ModelConfig, tokens: torch.Tensor, s_max: int | None = None,
            policy: ExecutionPolicy | None = None):
    """Run the stack over the prompt: (last-position logits (B, 1, V) float32, DecodeState).

    The caches are padded out to s_max; a local slot keeps the last `window`
    entries, rolled so that position p sits at slot p % S_eff (decode's
    invariant).
    """
    check_dense(cfg)
    policy = resolve_policy(cfg, policy)
    b, s = tokens.shape
    s_max = s_max or s
    _, g = group_geometry(cfg)
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = embed_tokens(params, cfg, tokens)
    kvs = [[] for _ in range(g)]
    for i, block in enumerate(params.blocks):
        h, kv = block(h, positions=positions, collect_kv=True, attn_block=cfg.attn_block,
                      policy=policy)
        kvs[i % g].append(kv)
    h = params.final_norm(h)
    logits = (h[:, -1:] @ lm_head_weights(params, cfg)).to(torch.float32)

    caches = []
    for slot, slot_type in enumerate(cfg.layer_pattern):
        k = torch.stack([kv[0] for kv in kvs[slot]])  # (n_groups, B, S, Hkv, Dh)
        v = torch.stack([kv[1] for kv in kvs[slot]])
        s_eff = _s_eff(cfg, slot_type, s_max)
        if s_eff > s:
            k, v = (F.pad(t, (0, 0, 0, 0, 0, s_eff - s)) for t in (k, v))
        elif s_eff < s:
            k, v = k[:, :, -s_eff:], v[:, :, -s_eff:]
            shift = s % s_eff
            if shift:
                k, v = torch.roll(k, shift, dims=2), torch.roll(v, shift, dims=2)
        if cfg.kv_quant == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            caches.append(QuantKVCache(kq, vq, ks, vs))
        else:
            caches.append(KVCache(k, v))
    cache_len = torch.full((), s, dtype=torch.int32, device=tokens.device)
    return logits, DecodeState(caches=tuple(caches), cache_len=cache_len)


def decode_step(params: DenseLM, cfg: ModelConfig, state: DecodeState, token: torch.Tensor,
                policy: ExecutionPolicy | None = None):
    """One decode step.  token: (B, 1) int -> (logits (B, 1, V) float32, new DecodeState).

    A global slot writes at cache_len and attends over cache_len + 1
    entries; past the end of its cache the write lands on the last slot (the
    reference's clamped update).  A local slot writes at cache_len % S_eff and
    attends over min(cache_len + 1, S_eff) entries.
    """
    check_dense(cfg)
    policy = resolve_policy(cfg, policy)
    _, g = group_geometry(cfg)
    cl = state.cache_len
    pos = cl.reshape(1, 1).to(torch.int32)
    h = embed_tokens(params, cfg, token)
    new = [[] for _ in range(g)]
    for i, block in enumerate(params.blocks):
        slot, grp = i % g, i // g
        stacked = state.caches[slot]
        cache = type(stacked)(*(t[grp] for t in stacked))
        if block.slot_type == "local" and cfg.window:
            s_eff = cache.k.shape[1]
            write_idx, attend_len = torch.remainder(cl, s_eff), torch.clamp(cl + 1, max=s_eff)
        else:
            write_idx, attend_len = cl, cl + 1
        h, nc = block(h, positions=pos, cache=cache, write_idx=write_idx,
                      attend_len=attend_len, decode_window=None, attn_block=cfg.attn_block,
                      policy=policy)
        new[slot].append(nc)
    h = params.final_norm(h)
    logits = (h @ lm_head_weights(params, cfg)).to(torch.float32)
    caches = tuple(type(state.caches[slot])(*(torch.stack(parts) for parts in zip(*new[slot])))
                   for slot in range(g))
    return logits, DecodeState(caches=caches, cache_len=cl + 1)
