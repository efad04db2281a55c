"""Uniform per-family LM API (`get_family_api`) and the ssm and hybrid families.

The JAX package's `models/families.py`.  Every family exposes:

    init(cfg, *, generator=None, device=None)             -> params (an nn.Module)
    train_loss(params, cfg, batch, policy=None)           -> (loss, metrics)
    prefill(params, cfg, batch, s_max=None, policy=None)  -> (logits, decode state)
    decode_step(params, cfg, state, batch, policy=None)   -> (logits, new state)
    init_decode_state(cfg, batch, s_max, *, device=None)  -> zeroed decode state

Batches are {tokens, labels} (train), {tokens} (prefill), {token} (decode).
`dense` and `moe` run in `models/transformer.py`; `ssm` (mamba2-1.3b: a
stack of Mamba-2 blocks) and `hybrid` (recurrentgemma-2b: RG-LRU and local
attention in the pattern recurrent/recurrent/local, with n_layers % 3
remainder layers after the groups) are here.  Both tie the LM head to the
embedding: float32 logits h @ embed.T, and `chunked_cross_entropy`
against embed.T in training.  `encdec` and `vlm` raise NotImplementedError
until ROADMAP.md queue A step 3e.

Layers are one `ModuleList` in order where the reference stacks them:
the ssm's layer i is the reference's `blocks` leaf i, the hybrid's layer i
of `blocks` is group i // g, slot i % g, and its `rem` are unstacked.
Training remats each ssm layer and each hybrid group as `cfg.remat` says,
never the hybrid's remainder layers, as the reference does.  Decode keeps
each slot's caches stacked over the groups; `cache_len` is a 0-d int32
tensor on the model's device, and nothing reads a value back to the host.
The hybrid's caches are float in any `kv_quant`, as the reference's are.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models import transformer as T
from repro_torch.models.layers import GLUMLP, Attention, KVCache, RMSNorm
from repro_torch.models.mamba2 import Mamba2, SSMCache, mamba2_dims
from repro_torch.models.rglru import CONV_WIDTH, RGLRU, LRUCache


def _embedding(cfg: ModelConfig, generator, device) -> nn.Parameter:
    draw_on = None if generator is None else generator.device
    e = torch.randn(cfg.vocab_size, cfg.d_model, generator=generator, device=draw_on) * 0.02
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
    return h + out


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
# Dispatch
# ===========================================================================


def get_family_api(cfg: ModelConfig) -> dict:
    """{"init", "train_loss", "prefill", "decode_step", "init_decode_state"} of cfg's family.

    `train_loss(params, cfg, batch, policy=None)` reads batch["tokens"] and
    batch["labels"] and returns (loss, metrics); `prefill(params, cfg,
    batch, s_max=None, policy=None)` reads batch["tokens"],
    `decode_step(params, cfg, state, batch, policy=None)` batch["token"],
    as in the reference.
    """
    fam = cfg.family
    if fam in T.TRANSFORMER_FAMILIES:
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
    if fam in ("encdec", "vlm"):
        raise NotImplementedError(T.NOT_PORTED_FAMILY.format(name=cfg.name, family=fam))
    raise ValueError(f"unknown family {fam}")
