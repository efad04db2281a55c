"""Uniform per-family LM API (`get_family_api`) and the ssm, hybrid, encdec and
vlm families.

The JAX package's `models/families.py`.  Every family exposes:

    init(cfg, *, generator=None, device=None)             -> params (an nn.Module)
    train_loss(params, cfg, batch, policy=None)           -> (loss, metrics)
    prefill(params, cfg, batch, s_max=None, policy=None)  -> (logits, decode state)
    decode_step(params, cfg, state, batch, policy=None)   -> (logits, new state)
    init_decode_state(cfg, batch, s_max, *, device=None)  -> zeroed decode state

Batches are {tokens, labels} (train), {tokens} (prefill), {token} (decode);
encdec adds enc_embeds (B, S_enc, D) and vlm patch_embeds (B, P, D) to the
train and prefill batches, the stubbed frontends' outputs.  `dense` and
`moe` run in `models/transformer.py`; here are `ssm` (mamba2-1.3b: a stack
of Mamba-2 blocks), `hybrid` (recurrentgemma-2b: RG-LRU and local attention
in the pattern recurrent/recurrent/local, with n_layers % 3 remainder
layers after the groups), `encdec` (whisper-small: a non-causal encoder
over the frame embeddings, then a decoder whose layers cross-attend to its
output; absolute sinusoidal positions on both sides) and `vlm`
(internvl2-2b: the dense stack over [projected patches; tokens]).  ssm,
hybrid and encdec tie the LM head to the embedding: float32 logits h @
embed.T, and `chunked_cross_entropy` against embed.T in training.

Layers are one `ModuleList` in order where the reference stacks them:
the ssm's layer i is the reference's `blocks` leaf i, the hybrid's layer i
of `blocks` is group i // g, slot i % g, and its `rem` are unstacked;
encdec's `enc_blocks` and `dec_blocks` are each stacked over their layers.
Training remats each ssm layer, each hybrid group and each encdec encoder
and decoder layer as `cfg.remat` says, never the hybrid's remainder layers,
as the reference does.  Decode keeps each slot's caches stacked over the
groups; `cache_len` is a 0-d int32 tensor on the model's device, and
nothing reads a value back to the host.  The hybrid's, encdec's and vlm's
caches are float in any `kv_quant`, as the reference's are.  The residual
stream passes `sharding.hints.hint_residual` where the reference's does:
after each ssm layer in training, after each hybrid group's layers (not
the remainder layers), and after each encoder layer and, in training,
each decoder layer.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    GLUMLP,
    Attention,
    DenseMLP,
    KVCache,
    RMSNorm,
)
from repro_torch.models.mamba2 import Mamba2, SSMCache, mamba2_dims
from repro_torch.models.nn import Linear, draw_normal
from repro_torch.models.rglru import CONV_WIDTH, RGLRU, LRUCache
from repro_torch.sharding.hints import hint_residual


def _embedding(cfg: ModelConfig, generator, device) -> nn.Parameter:
    e = draw_normal(cfg.vocab_size, cfg.d_model, generator=generator, device=device) * 0.02
    return nn.Parameter(e.to(device=device, dtype=cfg.dtype))


def _stack(caches: list, kind):
    """Per-layer caches -> one cache of `kind` with every field stacked over them."""
    return kind(*(torch.stack(parts) for parts in zip(*caches)))


# ===========================================================================
# SSM family (mamba2)
# ===========================================================================


class SSMBlock(nn.Module):
    """One pre-norm layer: h + mixer(norm h), the mixer a Mamba-2 block."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, device=device, dtype=cfg.dtype)
        self.mixer = Mamba2(cfg, generator=generator, device=device, dtype=cfg.dtype)


class SSMLM(nn.Module):
    """The reference's `ssm_init` tree: `embed` (V, D) N(0, 0.02^2), `blocks` (the
    L layers), `final_norm`."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _embedding(cfg, generator, device)
        self.blocks = nn.ModuleList(SSMBlock(cfg, generator=generator, device=device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device, dtype=cfg.dtype)


class SSMState(NamedTuple):
    """SSMCache with every field stacked over the layers (L, ...), and cache_len."""

    caches: SSMCache
    cache_len: torch.Tensor


def ssm_init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
             device=None) -> SSMLM:
    """Seeded parameters with the reference's distributions, drawn on the generator's
    device, on the card unless `device` names another."""
    return SSMLM(cfg, generator=generator, device=resolve_device(device))


def _ssm_layer(block: SSMBlock, cfg, policy, h: torch.Tensor) -> torch.Tensor:
    out, _, _ = block.mixer(block.norm(h), policy=policy)
    return hint_residual(h + out)


def ssm_train_loss(params: SSMLM, cfg: ModelConfig, batch: dict,
                   policy: ExecutionPolicy | None = None) -> tuple[torch.Tensor, dict]:
    """batch: {tokens (B, S), labels (B, S)} -> (loss, {"loss": loss}); each layer one
    remat unit."""
    policy = resolve_policy(cfg, policy)
    h = F.embedding(batch["tokens"], params.embed)
    for block in params.blocks:
        h = T.remat(cfg, functools.partial(_ssm_layer, block, cfg, policy), h)
    h = params.final_norm(h)
    loss = T.chunked_cross_entropy(h, params.embed.t(), batch["labels"], chunk=cfg.loss_chunk)
    return loss, {"loss": loss}


def ssm_init_decode_state(cfg: ModelConfig, batch: int, s_max: int, *,
                          device=None) -> SSMState:
    """Zero states and conv histories for `batch` sequences (s_max does not matter:
    the state does not grow)."""
    dev = resolve_device(device)
    _, n_heads, conv_dim = mamba2_dims(cfg)
    cache = SSMCache(
        state=torch.zeros((cfg.n_layers, batch, n_heads, cfg.ssm_headdim, cfg.ssm_state),
                          dtype=torch.float32, device=dev),
        conv=torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=cfg.dtype,
                         device=dev))
    return SSMState(caches=cache, cache_len=torch.zeros((), dtype=torch.int32, device=dev))


def ssm_prefill(params: SSMLM, cfg: ModelConfig, batch: dict, s_max: int | None = None,
                policy: ExecutionPolicy | None = None):
    """(last-position logits (B, 1, V) float32, SSMState) of the prompt."""
    policy = resolve_policy(cfg, policy)
    tokens = batch["tokens"]
    h = F.embedding(tokens, params.embed)
    caches = []
    for block in params.blocks:
        out, cache, _ = block.mixer(block.norm(h), policy=policy)
        h = h + out
        caches.append(cache)
    h = params.final_norm(h)
    logits = (h[:, -1:] @ params.embed.t()).to(torch.float32)
    cache_len = torch.full((), tokens.shape[1], dtype=torch.int32, device=tokens.device)
    return logits, SSMState(caches=_stack(caches, SSMCache), cache_len=cache_len)


def ssm_decode_step(params: SSMLM, cfg: ModelConfig, state: SSMState, batch: dict,
                    policy: ExecutionPolicy | None = None):
    """One token: (logits (B, 1, V) float32, new SSMState)."""
    policy = resolve_policy(cfg, policy)
    h = F.embedding(batch["token"], params.embed)
    caches = []
    for i, block in enumerate(params.blocks):
        cache = SSMCache(*(t[i] for t in state.caches))
        out, new_cache, _ = block.mixer(block.norm(h), cache=cache, policy=policy)
        h = h + out
        caches.append(new_cache)
    h = params.final_norm(h)
    logits = (h @ params.embed.t()).to(torch.float32)
    return logits, SSMState(caches=_stack(caches, SSMCache), cache_len=state.cache_len + 1)


# ===========================================================================
# Hybrid family (recurrentgemma: pattern recurrent/recurrent/local-attn)
# ===========================================================================


def hybrid_geometry(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, layers a group, remainder layers): layer i < n_groups * g is group
    i // g, slot i % g; remainder layer r takes layer_pattern[r]."""
    g = len(cfg.layer_pattern)
    return cfg.n_layers // g, g, cfg.n_layers % g


def _s_eff(cfg: ModelConfig, s_max: int) -> int:
    """An attention cache's length: the window, where the config has one, for
    every attention slot, as in the reference."""
    return min(s_max, cfg.window) if cfg.window else s_max


class HybridSlot(nn.Module):
    """One hybrid layer: h + mixer(ln1 h), then h + mlp(ln2 h); the mixer an RG-LRU
    block ("recurrent") or attention (its slot's config), the mlp a GLU."""

    def __init__(self, cfg: ModelConfig, slot_type: str, *, generator=None, device=None):
        super().__init__()
        dtype = cfg.dtype
        self.slot_type = slot_type
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if slot_type == "recurrent":
            self.mixer = RGLRU(cfg, generator=generator, device=device, dtype=dtype)
        else:
            self.mixer = Attention(T.attn_cfg_for(cfg, slot_type), generator=generator,
                                   device=device, dtype=dtype)
        self.mlp = GLUMLP(cfg.d_model, cfg.d_ff, bias=cfg.use_bias, act=cfg.act,
                          generator=generator, device=device, dtype=dtype)

    def forward(self, h: torch.Tensor, *, positions: torch.Tensor, attn_block: int,
                cache=None, cache_len: torch.Tensor | None = None,
                policy: ExecutionPolicy | None = None):
        """(h, this layer's new cache).  Without a cache an attention slot returns
        its fresh K/V; with one it writes at cache_len % S_eff and attends over
        min(cache_len + 1, S_eff) entries (a rolling window buffer)."""
        x = self.ln1(h)
        if self.slot_type == "recurrent":
            out, new_cache = self.mixer(x, cache=cache, policy=policy)
        elif cache is None:
            out, kv = self.mixer(x, positions=positions, collect_kv=True,
                                 attn_block=attn_block, policy=policy)
            new_cache = KVCache(*kv)
        else:
            s_eff = cache.k.shape[1]
            out, new_cache = self.mixer(
                x, positions=positions, cache=cache, write_idx=torch.remainder(cache_len, s_eff),
                attend_len=torch.clamp(cache_len + 1, max=s_eff), decode_window=None,
                attn_block=attn_block, policy=policy)
        h = h + out
        h = h + self.mlp(self.ln2(h), policy=policy)
        return h, new_cache


class HybridLM(nn.Module):
    """The reference's `hybrid_init` tree: `embed` (V, D) N(0, 0.02^2), `blocks`
    (n_groups * g layers, layer i = group i // g, slot i % g), `rem` (the
    remainder layers) and `final_norm`."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        n_groups, g, rem = hybrid_geometry(cfg)
        pattern = cfg.layer_pattern
        self.embed = _embedding(cfg, generator, device)
        self.blocks = nn.ModuleList(
            HybridSlot(cfg, pattern[i % g], generator=generator, device=device)
            for i in range(n_groups * g))
        self.rem = nn.ModuleList(HybridSlot(cfg, pattern[r], generator=generator, device=device)
                                 for r in range(rem))
        self.final_norm = RMSNorm(cfg.d_model, device=device, dtype=cfg.dtype)


class HybridState(NamedTuple):
    """Per slot its caches stacked over the groups (LRUCache or KVCache), per
    remainder layer its cache, and cache_len."""

    group_caches: tuple
    rem_caches: tuple
    cache_len: torch.Tensor


def hybrid_init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> HybridLM:
    """Seeded parameters with the reference's distributions, drawn on the generator's
    device, on the card unless `device` names another."""
    return HybridLM(cfg, generator=generator, device=resolve_device(device))


def _zero_cache(cfg: ModelConfig, slot_type: str, batch: int, s_max: int, lead: tuple, dev):
    if slot_type == "recurrent":
        w = cfg.lru_width or cfg.d_model
        return LRUCache(h=torch.zeros(lead + (batch, w), dtype=torch.float32, device=dev),
                        conv=torch.zeros(lead + (batch, CONV_WIDTH - 1, w), dtype=cfg.dtype,
                                         device=dev))
    shape = lead + (batch, _s_eff(cfg, s_max), cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


def hybrid_init_decode_state(cfg: ModelConfig, batch: int, s_max: int, *,
                             device=None) -> HybridState:
    """Zero caches for `batch` sequences of up to `s_max` positions (attention caches
    of the window where the config has one), on the card unless `device` names
    another."""
    dev = resolve_device(device)
    n_groups, _, rem = hybrid_geometry(cfg)
    return HybridState(
        tuple(_zero_cache(cfg, t, batch, s_max, (n_groups,), dev) for t in cfg.layer_pattern),
        tuple(_zero_cache(cfg, cfg.layer_pattern[r], batch, s_max, (), dev) for r in range(rem)),
        torch.zeros((), dtype=torch.int32, device=dev))


def _hybrid_run(params: HybridLM, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                *, state: HybridState | None, collect: bool,
                policy: ExecutionPolicy | None):
    """The layer stack.  state None: train (collect False: each group one remat
    unit, never the remainder layers) or prefill (collect True); else one decode
    step.  Returns (h after the final norm, per slot the groups' new caches, per
    remainder layer its cache); training keeps no group caches."""
    n_groups, g, _ = hybrid_geometry(cfg)
    kw = dict(positions=positions, attn_block=cfg.attn_block, policy=policy)
    cl = None if state is None else state.cache_len
    group_out = [[] for _ in range(g)]

    def group(start: int, hh: torch.Tensor, *, keep: bool = False) -> torch.Tensor:
        for slot in range(g):
            cache = None
            if state is not None:
                stacked = state.group_caches[slot]
                cache = type(stacked)(*(t[start // g] for t in stacked))
            hh, new_cache = params.blocks[start + slot](hh, cache=cache, cache_len=cl, **kw)
            hh = hint_residual(hh)
            if keep:
                group_out[slot].append(new_cache)
        return hh

    for start in range(0, n_groups * g, g):
        if state is None and not collect:
            h = T.remat(cfg, functools.partial(group, start), h)
        else:
            h = group(start, h, keep=True)
    rem_out = []
    for r, layer in enumerate(params.rem):
        cache = None if state is None else state.rem_caches[r]
        h, new_cache = layer(h, cache=cache, cache_len=cl, **kw)
        rem_out.append(new_cache)
    groups = tuple(_stack(parts, type(parts[0])) if parts else None for parts in group_out)
    return params.final_norm(h), groups, tuple(rem_out)


def hybrid_train_loss(params: HybridLM, cfg: ModelConfig, batch: dict,
                      policy: ExecutionPolicy | None = None) -> tuple[torch.Tensor, dict]:
    """batch: {tokens (B, S), labels (B, S)} -> (loss, {"loss": loss})."""
    policy = resolve_policy(cfg, policy)
    tokens = batch["tokens"]
    h = F.embedding(tokens, params.embed)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    h, _, _ = _hybrid_run(params, cfg, h, positions, state=None, collect=False, policy=policy)
    loss = T.chunked_cross_entropy(h, params.embed.t(), batch["labels"], chunk=cfg.loss_chunk)
    return loss, {"loss": loss}


def hybrid_prefill(params: HybridLM, cfg: ModelConfig, batch: dict, s_max: int | None = None,
                   policy: ExecutionPolicy | None = None):
    """(last-position logits (B, 1, V) float32, HybridState) of the prompt: attention
    caches truncated to the window and rolled so that position p sits at slot
    p % S_eff, or padded out to s_max."""
    policy = resolve_policy(cfg, policy)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    s_eff = _s_eff(cfg, s_max or s)
    h = F.embedding(tokens, params.embed)
    positions = torch.arange(s, device=tokens.device)[None]
    h, group_out, rem_out = _hybrid_run(params, cfg, h, positions, state=None, collect=True,
                                        policy=policy)
    logits = (h[:, -1:] @ params.embed.t()).to(torch.float32)

    def fit(cache, dim: int):
        if isinstance(cache, KVCache):
            return KVCache(*(T.fit_cache(t, s_eff, dim=dim) for t in cache))
        return cache

    cache_len = torch.full((), s, dtype=torch.int32, device=tokens.device)
    return logits, HybridState(tuple(fit(c, 2) for c in group_out),
                               tuple(fit(c, 1) for c in rem_out), cache_len)


def hybrid_decode_step(params: HybridLM, cfg: ModelConfig, state: HybridState, batch: dict,
                       policy: ExecutionPolicy | None = None):
    """One token: (logits (B, 1, V) float32, new HybridState)."""
    policy = resolve_policy(cfg, policy)
    h = F.embedding(batch["token"], params.embed)
    pos = state.cache_len.reshape(1, 1)
    h, group_out, rem_out = _hybrid_run(params, cfg, h, pos, state=state, collect=False,
                                        policy=policy)
    logits = (h @ params.embed.t()).to(torch.float32)
    return logits, HybridState(group_out, rem_out, state.cache_len + 1)


# ===========================================================================
# Encoder-decoder family (whisper: the audio frontend stubbed, as in the reference)
# ===========================================================================


def sinusoidal_pos(s: int, d: int, device=None) -> torch.Tensor:
    """(s, d) float32 absolute positions [sin, cos] of pos * exp(-log(10000) i / (d/2)).

    The reference's formula, in float32.  Not bitwise across the two
    packages: XLA's CPU exp, sin and cos land an ulp from torch's on some
    entries, so the tables differ by up to the angle's ulp.
    """
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _pad_cache(cache: KVCache, s_max: int) -> KVCache:
    """A stacked (L, B, S, Hkv, Dh) cache padded with zeros to s_max positions
    (transformer.fit_cache); left as it is when it holds s_max or more."""
    if s_max <= cache.k.shape[2]:
        return cache
    return KVCache(*(T.fit_cache(t, s_max, dim=2) for t in cache))


class EncBlock(nn.Module):
    """One encoder layer: h + attn(ln1 h) (non-causal), then h + mlp(ln2 h) (GELU)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        dtype = cfg.dtype
        self.ln1 = T.norm(cfg, device, dtype)
        self.attn = Attention(T.attn_cfg_for(cfg, "global", causal=False), generator=generator,
                              device=device, dtype=dtype)
        self.ln2 = T.norm(cfg, device, dtype)
        self.mlp = DenseMLP(cfg.d_model, cfg.d_ff, bias=cfg.use_bias, act="gelu",
                            generator=generator, device=device, dtype=dtype)

    def forward(self, h: torch.Tensor, *, positions: torch.Tensor, attn_block: int,
                policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """(B, S_enc, D) -> (B, S_enc, D)."""
        a, _ = self.attn(self.ln1(h), positions=positions, attn_block=attn_block, policy=policy)
        h = h + a
        return h + self.mlp(self.ln2(h), policy=policy)


class DecBlock(nn.Module):
    """One decoder layer (the reference's `_dec_slot_apply`): h + self_attn(ln1 h)
    (causal), h + cross_attn(ln_x h) over the encoder output, then h + mlp(ln2 h)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        dtype = cfg.dtype
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = T.norm(cfg, device, dtype)
        self.self_attn = Attention(T.attn_cfg_for(cfg, "global"), **kw)
        self.ln_x = T.norm(cfg, device, dtype)
        self.cross_attn = Attention(T.attn_cfg_for(cfg, "global", causal=False), **kw)
        self.ln2 = T.norm(cfg, device, dtype)
        self.mlp = DenseMLP(cfg.d_model, cfg.d_ff, bias=cfg.use_bias, act="gelu", **kw)

    def forward(self, h: torch.Tensor, enc_out: torch.Tensor | None = None, *,
                positions: torch.Tensor, attn_block: int, self_cache: KVCache | None = None,
                cache_len: torch.Tensor | None = None, cross: KVCache | None = None,
                collect: bool = False, policy: ExecutionPolicy | None = None):
        """(h, new self cache, cross K/V).

        Train and prefill (no caches): the self-attention is causal flash
        attention, and the cross-attention projects enc_out through wk / wv
        once; with `collect` both K/V pairs come back as the layer's caches,
        else (None, None).  Decode (self_cache and cross given, S == 1):
        the new K/V written at cache_len, attention over cache_len + 1
        entries, and the cross-attention over all S_enc cached entries; the
        cross cache comes back as it was.
        """
        x = self.ln1(h)
        if self_cache is None:
            a, kv = self.self_attn(x, positions=positions, collect_kv=collect,
                                   attn_block=attn_block, policy=policy)
            new_self = KVCache(*kv) if collect else None
        else:
            a, new_self = self.self_attn(x, positions=positions, cache=self_cache,
                                         write_idx=cache_len, attend_len=cache_len + 1,
                                         attn_block=attn_block, policy=policy)
        h = h + a
        xq = self.ln_x(h)
        if cross is None:
            c, kv = self.cross_attn(xq, positions=positions, kv_override=(enc_out, enc_out),
                                    collect_kv=collect, attn_block=attn_block, policy=policy)
            new_cross = KVCache(*kv) if collect else None
        else:
            c, _ = self.cross_attn(xq, positions=positions, kv_override=cross, policy=policy)
            new_cross = cross
        h = h + c
        h = h + self.mlp(self.ln2(h), policy=policy)
        return h, new_self, new_cross


class EncDecLM(nn.Module):
    """The reference's `encdec_init` tree: `embed` (V, D) N(0, 0.02^2), the LM head
    tied to it; `enc_blocks` (encoder_layers) and `dec_blocks` (n_layers), each in
    layer order; `enc_norm` and `final_norm` (LayerNorm for whisper)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _embedding(cfg, generator, device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, generator=generator, device=device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, generator=generator, device=device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = T.norm(cfg, device, cfg.dtype)
        self.final_norm = T.norm(cfg, device, cfg.dtype)


class EncDecState(NamedTuple):
    """The decoder's self caches (L, B, S_max, Hkv, Dh), its cross caches (L, B,
    S_enc, Hkv, Dh), both float KVCaches, and cache_len."""

    self_caches: KVCache
    cross_caches: KVCache
    cache_len: torch.Tensor


def encdec_init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> EncDecLM:
    """Seeded parameters with the reference's distributions, drawn on the generator's
    device, on the card unless `device` names another."""
    return EncDecLM(cfg, generator=generator, device=resolve_device(device))


def _enc_layer(block: EncBlock, positions, attn_block: int, policy, h: torch.Tensor):
    return hint_residual(block(h, positions=positions, attn_block=attn_block, policy=policy))


def encode(params: EncDecLM, cfg: ModelConfig, enc_embeds: torch.Tensor,
           policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """The reference's `_encode`: enc_embeds (B, S_enc, D), the stubbed frontend's
    output, plus the sinusoidal table in enc_embeds' own dtype, through the
    encoder (each layer one remat unit) and `enc_norm`."""
    s = enc_embeds.shape[1]
    h = enc_embeds + sinusoidal_pos(s, cfg.d_model, enc_embeds.device)[None].to(enc_embeds.dtype)
    positions = torch.arange(s, device=enc_embeds.device)[None]
    for block in params.enc_blocks:
        h = T.remat(cfg, functools.partial(_enc_layer, block, positions, cfg.attn_block, policy),
                    h)
    return params.enc_norm(h)


def _dec_embed(params: EncDecLM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the sinusoidal table, in the embedding's dtype."""
    h = F.embedding(tokens, params.embed)
    return h + sinusoidal_pos(tokens.shape[1], cfg.d_model, h.device)[None].to(h.dtype)


def _dec_layer(block: DecBlock, enc_out, positions, attn_block: int, policy, h: torch.Tensor):
    return hint_residual(block(h, enc_out, positions=positions, attn_block=attn_block,
                               policy=policy)[0])


def encdec_train_loss(params: EncDecLM, cfg: ModelConfig, batch: dict,
                      policy: ExecutionPolicy | None = None) -> tuple[torch.Tensor, dict]:
    """batch: {enc_embeds (B, S_enc, D), tokens (B, S), labels (B, S)} -> (loss,
    {"loss": loss}); each encoder and each decoder layer one remat unit."""
    policy = resolve_policy(cfg, policy)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    enc_out = encode(params, cfg, batch["enc_embeds"], policy=policy)
    h = _dec_embed(params, cfg, tokens)
    for block in params.dec_blocks:
        h = T.remat(cfg, functools.partial(_dec_layer, block, enc_out, positions,
                                           cfg.attn_block, policy), h)
    h = params.final_norm(h)
    loss = T.chunked_cross_entropy(h, params.embed.t(), batch["labels"], chunk=cfg.loss_chunk)
    return loss, {"loss": loss}


def encdec_init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                             s_enc: int | None = None, *, device=None) -> EncDecState:
    """Zero float caches: self caches of s_max positions, cross caches of s_enc
    (s_max when not given), in cfg.dtype whatever cfg.kv_quant says."""
    dev = resolve_device(device)
    s_enc = s_enc or s_max

    def zeros(s):
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       torch.zeros(shape, dtype=cfg.dtype, device=dev))

    return EncDecState(zeros(s_max), zeros(s_enc), torch.zeros((), dtype=torch.int32,
                                                               device=dev))


def encdec_prefill(params: EncDecLM, cfg: ModelConfig, batch: dict, s_max: int | None = None,
                   policy: ExecutionPolicy | None = None):
    """(last-position logits (B, 1, V) float32, EncDecState) of {enc_embeds, tokens}:
    the self caches padded to s_max, the cross caches the encoder output's K/V
    (S_enc positions), projected once."""
    policy = resolve_policy(cfg, policy)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    enc_out = encode(params, cfg, batch["enc_embeds"], policy=policy)
    h = _dec_embed(params, cfg, tokens)
    selfs, crosses = [], []
    for block in params.dec_blocks:
        h, sc, cc = block(h, enc_out, positions=positions, attn_block=cfg.attn_block,
                          collect=True, policy=policy)
        selfs.append(sc)
        crosses.append(cc)
    h = params.final_norm(h)
    logits = (h[:, -1:] @ params.embed.t()).to(torch.float32)
    cache_len = torch.full((), s, dtype=torch.int32, device=tokens.device)
    return logits, EncDecState(_pad_cache(_stack(selfs, KVCache), s_max or s),
                               _stack(crosses, KVCache), cache_len)


def encdec_decode_step(params: EncDecLM, cfg: ModelConfig, state: EncDecState, batch: dict,
                       policy: ExecutionPolicy | None = None):
    """One token: (logits (B, 1, V) float32, new EncDecState).  The position row
    comes from a table of the self caches' S_max rows, gathered at cache_len on
    the device (clamped to the last row, where the cache write clamps too)."""
    policy = resolve_policy(cfg, policy)
    cl = state.cache_len
    pos = cl.reshape(1, 1)
    h = F.embedding(batch["token"], params.embed)
    s_max = state.self_caches.k.shape[2]
    row = torch.clamp(cl, max=s_max - 1).reshape(1).to(torch.int64)
    h = h + sinusoidal_pos(s_max, cfg.d_model, h.device).index_select(0, row)[None].to(h.dtype)
    selfs = []
    for i, block in enumerate(params.dec_blocks):
        h, sc, _ = block(h, positions=pos, attn_block=cfg.attn_block,
                         self_cache=KVCache(*(t[i] for t in state.self_caches)), cache_len=cl,
                         cross=KVCache(*(t[i] for t in state.cross_caches)), policy=policy)
        selfs.append(sc)
    h = params.final_norm(h)
    logits = (h @ params.embed.t()).to(torch.float32)
    return logits, EncDecState(_stack(selfs, KVCache), state.cross_caches, cl + 1)


# ===========================================================================
# VLM family (internvl2: the ViT frontend stubbed, the dense LM backbone)
# ===========================================================================


class VLM(T.DenseLM):
    """The reference's `vlm_init` tree: the dense LM's, plus `patch_proj`, a
    (d_model, d_model) linear with a bias in cfg.dtype: the learned connector
    that stands in for the mlp1 bridge."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__(cfg, generator=generator, device=device)
        self.patch_proj = Linear(cfg.d_model, cfg.d_model, bias=True, generator=generator,
                                 device=device, dtype=cfg.dtype)


def vlm_init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
             device=None) -> VLM:
    """Seeded parameters with the reference's distributions, drawn on the generator's
    device, on the card unless `device` names another."""
    return VLM(cfg, generator=generator, device=resolve_device(device))


def vlm_embed(params: VLM, cfg: ModelConfig, batch: dict,
              policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """[patch_proj(patch_embeds in cfg.dtype); token embeddings] -> (B, P + S_text, D)."""
    patches = params.patch_proj(batch["patch_embeds"].to(cfg.dtype), policy=policy)
    return torch.cat([patches, F.embedding(batch["tokens"], params.embed)], dim=1)


def vlm_train_loss(params: VLM, cfg: ModelConfig, batch: dict,
                   policy: ExecutionPolicy | None = None) -> tuple[torch.Tensor, dict]:
    """batch: {patch_embeds (B, P, D), tokens (B, S), labels (B, S)} -> (loss,
    {"loss": loss}): the backbone over positions 0..P+S-1, the cross entropy over
    the text positions only."""
    policy = resolve_policy(cfg, policy)
    h = vlm_embed(params, cfg, batch, policy=policy)
    h = T.backbone(params, cfg, h, torch.arange(h.shape[1], device=h.device)[None],
                   policy=policy)
    n_p = batch["patch_embeds"].shape[1]
    loss = T.chunked_cross_entropy(h[:, n_p:], T.lm_head_weights(params, cfg), batch["labels"],
                                   chunk=cfg.loss_chunk)
    return loss, {"loss": loss}


def vlm_prefill(params: VLM, cfg: ModelConfig, batch: dict, s_max: int | None = None,
                policy: ExecutionPolicy | None = None):
    """(last-position logits (B, 1, V) float32, transformer.DecodeState) over
    [patches; prompt tokens]: cache_len is P + S_text, so s_max must count the
    patches.  The caches are float KVCaches padded to s_max whatever
    cfg.kv_quant says, as the reference's are, so decode takes the float path."""
    policy = resolve_policy(cfg, policy)
    h = vlm_embed(params, cfg, batch, policy=policy)
    s = h.shape[1]
    positions = torch.arange(s, device=h.device)[None]
    _, g = T.group_geometry(cfg)
    kvs = [[] for _ in range(g)]
    for i, block in enumerate(params.blocks):
        h, kv = block(h, positions=positions, collect_kv=True, attn_block=cfg.attn_block,
                      policy=policy)
        kvs[i % g].append(KVCache(*kv))
    h = params.final_norm(h)
    logits = (h[:, -1:] @ T.lm_head_weights(params, cfg)).to(torch.float32)
    caches = tuple(_pad_cache(_stack(parts, KVCache), s_max or s) for parts in kvs)
    cache_len = torch.full((), s, dtype=torch.int32, device=h.device)
    return logits, T.DecodeState(caches=caches, cache_len=cache_len)


def vlm_decode_step(params: VLM, cfg: ModelConfig, state: T.DecodeState, batch: dict,
                    policy: ExecutionPolicy | None = None):
    """One token through `transformer.decode_step` (the cache's type picks the path)."""
    return T.decode_step(params, cfg, state, batch["token"], policy=policy)


# ===========================================================================
# Dispatch
# ===========================================================================


def get_family_api(cfg: ModelConfig) -> dict:
    """{"init", "train_loss", "prefill", "decode_step", "init_decode_state"} of cfg's family.

    `train_loss(params, cfg, batch, policy=None)` reads batch["tokens"] and
    batch["labels"] and returns (loss, metrics); `prefill(params, cfg,
    batch, s_max=None, policy=None)` reads batch["tokens"],
    `decode_step(params, cfg, state, batch, policy=None)` batch["token"],
    as in the reference; encdec's train_loss and prefill read
    batch["enc_embeds"] too, and vlm's batch["patch_embeds"].  A family no
    package knows raises ValueError.
    """
    fam = cfg.family
    if fam in ("dense", "moe"):
        return {
            "init": T.init_lm,
            "train_loss": T.lm_loss,
            "prefill": lambda p, c, b, s_max=None, policy=None: T.prefill(
                p, c, b["tokens"], s_max, policy=policy),
            "decode_step": lambda p, c, st, b, policy=None: T.decode_step(
                p, c, st, b["token"], policy=policy),
            "init_decode_state": T.init_decode_state,
        }
    if fam == "ssm":
        return {"init": ssm_init, "train_loss": ssm_train_loss, "prefill": ssm_prefill,
                "decode_step": ssm_decode_step, "init_decode_state": ssm_init_decode_state}
    if fam == "hybrid":
        return {"init": hybrid_init, "train_loss": hybrid_train_loss, "prefill": hybrid_prefill,
                "decode_step": hybrid_decode_step,
                "init_decode_state": hybrid_init_decode_state}
    if fam == "encdec":
        return {"init": encdec_init, "train_loss": encdec_train_loss, "prefill": encdec_prefill,
                "decode_step": encdec_decode_step,
                "init_decode_state": encdec_init_decode_state}
    if fam == "vlm":
        return {"init": vlm_init, "train_loss": vlm_train_loss, "prefill": vlm_prefill,
                "decode_step": vlm_decode_step, "init_decode_state": T.init_decode_state}
    raise ValueError(f"unknown family {fam}")
