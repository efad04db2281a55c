"""Decoder-only transformer LM of the `dense` and `moe` families: the module,
its seeded init, and serving (prefill and decode with stacked KV caches).

The JAX package's `models/transformer.py` for stablelm-1.6b, starcoder2-3b,
gemma3-12b and command-r-plus-104b (dense), and granite-moe-3b-a800m and
dbrx-132b (moe), whose blocks put a routed mixture of experts
(`models/moe.py`) where the dense blocks have their MLP.  The vlm family
(internvl2-2b, `models.families.VLM`) is this dense stack behind a patch
connector, and decodes through `decode_step`.  The reference
scans over groups of `len(cfg.layer_pattern)` layers with each slot's
parameters stacked (n_groups, ...); here the layers are one `ModuleList`
in order, layer i being group i // g, slot i % g (`group_geometry`), which
is how `params.lm_from_jax_params` maps the stacked leaves.  Mixed local/global
patterns (gemma3's 5:1) give each slot its own attention config, so each
slot's sliding-window block pairs stay static.

Decode keeps, per slot, the caches of all groups stacked (n_groups, B,
S_eff, Hkv, Dh), as the reference's `DecodeState` does; a local slot's
cache holds only the last `window` positions, position p at slot p % S_eff.
Both steps are functional: they return a new state and leave the old one
as it was.  `cache_len` is a 0-d int32 tensor on the model's device and no
step reads anything back to the host, so a later change can capture decode
as a CUDA graph.

Training: `lm_loss` embeds the tokens, runs `backbone` (the layer stack
without caches, one activation checkpoint a group of layers as
`cfg.remat` says) and takes `chunked_cross_entropy` against the LM head,
never building the (B, S, V) logits.  Nothing there reads a value back to
the host.  The residual stream passes `sharding.hints.hint_residual` where
the reference's does: the block's two residual adds, and after each layer
of `backbone` and `prefill`.  A hint returns its input itself, so values
and the autograd graph do not change under `activation_sharding`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.overrides import overridable
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
from repro_torch.models.moe import MoE
from repro_torch.models.nn import LayerNorm, draw_normal
from repro_torch.sharding.hints import hint_residual

# The families whose layer stack is this module's Block: vlm is the dense
# stack behind a patch connector (`models.families.VLM`).
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def check_transformer(cfg: ModelConfig) -> None:
    """Raise ValueError unless `cfg` is of a family this module runs (dense, moe,
    and vlm's backbone); ssm, hybrid and encdec run in `models.families`."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family runs through "
                         "models.families.get_family_api, not the transformer")
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def attn_cfg_for(cfg: ModelConfig, slot_type: str, causal: bool = True) -> AttnConfig:
    """The attention config of one slot: local slots take the sliding window;
    causal=False for the encdec encoder's self-attention and cross-attention."""
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        window=cfg.window if slot_type == "local" else None,
        causal=causal,
        use_bias=cfg.use_bias,
    )


def group_geometry(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, layers a group): the layer pattern must divide the depth."""
    g = len(cfg.layer_pattern)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible by pattern {g}")
    return cfg.n_layers // g, g


def norm(cfg: ModelConfig, device, dtype) -> nn.Module:
    """The config's norm over d_model: LayerNorm ("ln") or RMSNorm."""
    if cfg.norm_kind == "ln":
        return LayerNorm(cfg.d_model, device=device, dtype=dtype)
    return RMSNorm(cfg.d_model, device=device, dtype=dtype)


class Block(nn.Module):
    """One pre-norm layer: h + attn(ln1 h), then h + mlp(ln2 h); the mlp is an MoE
    in the moe family."""

    def __init__(self, cfg: ModelConfig, slot_type: str, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dtype = cfg.dtype
        self.slot_type = slot_type
        self.ln1 = norm(cfg, device, dtype)
        self.attn = Attention(attn_cfg_for(cfg, slot_type), generator=generator, device=device,
                              dtype=dtype)
        self.ln2 = norm(cfg, device, dtype)
        if cfg.family == "moe":
            self.mlp = MoE(cfg, generator=generator, device=device, dtype=dtype)
        else:
            mlp = GLUMLP if cfg.mlp_kind == "glu" else DenseMLP
            self.mlp = mlp(cfg.d_model, cfg.d_ff, bias=cfg.use_bias, act=cfg.act,
                           generator=generator, device=device, dtype=dtype)

    def forward(self, h: torch.Tensor, *, positions: torch.Tensor, attn_block: int,
                policy: ExecutionPolicy | None = None, **attn_kw):
        """(B, S, D) -> (h, aux); `attn_kw` go to `Attention.forward` (cache, write_idx,
        attend_len, decode_window, collect_kv), and aux is what it returns."""
        a, aux = self.attn(self.ln1(h), positions=positions, attn_block=attn_block,
                           policy=policy, **attn_kw)
        h = h + hint_residual(a)
        h = h + hint_residual(self.mlp(self.ln2(h), policy=policy))
        return h, aux


class DenseLM(nn.Module):
    """A dense or moe LM's parameters: `embed` (V, D), `blocks` (layer i = group
    i // g, slot i % g), `final_norm`, and `lm_head` (D, V) unless the embeddings
    are tied."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        check_transformer(cfg)
        group_geometry(cfg)
        self.cfg = cfg
        dtype = cfg.dtype
        def normal(*shape):
            return draw_normal(*shape, generator=generator, device=device)

        self.embed = nn.Parameter((normal(cfg.vocab_size, cfg.d_model) * 0.02).to(
            device=device, dtype=dtype))
        self.final_norm = norm(cfg, device, dtype)
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
# Training: the layer stack and the chunked cross entropy
# ---------------------------------------------------------------------------

# Remat "block" keeps the outputs of the products without batch dimensions,
# as the reference's `dots_with_no_batch_dims_saveable` does: the linears'
# 2-D matmuls.  Attention's batched products (bmm) are recomputed, so no
# (q block, kv block) score tensor is kept.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, h: torch.Tensor) -> torch.Tensor:
    """fn(h) under the reference's `_maybe_remat`: "none" runs it plainly, "full"
    keeps only its input for the backward (a non-reentrant checkpoint), "block"
    keeps its dots too.  Values are the same either way."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(h)
    if cfg.remat not in ("full", "block"):
        raise ValueError(f"{cfg.name}: remat={cfg.remat!r} is not none, block or full")
    kw = {}
    if cfg.remat == "block":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, h, use_reentrant=False, **kw)


def backbone(params: DenseLM, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
             policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """Run the layer stack without a cache (training).  h: (B, S, D) -> (B, S, D),
    after the final norm; each group of len(cfg.layer_pattern) layers is one
    remat unit, as the reference's scan body is."""
    _, g = group_geometry(cfg)

    def group(start: int, hh: torch.Tensor) -> torch.Tensor:
        for block in params.blocks[start:start + g]:
            hh, _ = block(hh, positions=positions, attn_block=cfg.attn_block, policy=policy)
            hh = hint_residual(hh)
        return hh

    for start in range(0, len(params.blocks), g):
        h = remat(cfg, functools.partial(group, start), h)
    return params.final_norm(h)


def _ce_chunk(hh: torch.Tensor, w_out: torch.Tensor, ll: torch.Tensor,
              mm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked NLL sum, mask sum) of one chunk: float32 logits (B, c, V), lse - gold."""
    logits = (hh @ w_out).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ll[..., None].to(torch.int64))[..., 0]
    return ((lse - gold) * mm).sum(), mm.sum()


@overridable
def chunked_cross_entropy(h: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor, *,
                          chunk: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Seq-chunked CE.  h: (B, S, D), w_out: (D, V), labels: (B, S) -> scalar float32.

    Never builds (B, S, V): a chunk's logits live inside a non-reentrant
    checkpoint (the reference's `@jax.checkpoint` body), so the backward
    keeps only the chunk's inputs and recomputes its logits.  The chunk is
    min(chunk, S), halved while it does not divide S; the masked NLL sum is
    divided by max(mask sum, 1).
    """
    b, s, _ = h.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    if mask is None:
        mask = labels.new_ones(labels.shape, dtype=torch.float32)  # laid out as labels
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s, chunk):
        part = slice(c, c + chunk)
        args = (h[:, part], w_out, labels[:, part], mask[:, part])
        nll, n = (checkpoint(_ce_chunk, *args, use_reentrant=False) if torch.is_grad_enabled()
                  else _ce_chunk(*args))
        nll_sum = nll_sum + nll
        cnt = cnt + n
    return nll_sum / torch.clamp(cnt, min=1.0)


def lm_loss(params: DenseLM, cfg: ModelConfig, batch: dict,
            policy: ExecutionPolicy | None = None) -> tuple[torch.Tensor, dict]:
    """batch: {tokens (B, S), labels (B, S)} int tensors on the params' device ->
    (loss, {"loss": loss}), the mean next-token NLL over every position."""
    check_transformer(cfg)
    policy = resolve_policy(cfg, policy)
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    h = backbone(params, cfg, h, torch.arange(tokens.shape[1], device=tokens.device)[None, :],
                 policy=policy)
    loss = chunked_cross_entropy(h, lm_head_weights(params, cfg), batch["labels"],
                                 chunk=cfg.loss_chunk)
    return loss, {"loss": loss}


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


def fit_cache(t: torch.Tensor, s_eff: int, *, dim: int) -> torch.Tensor:
    """A prefill's K or V of S positions along `dim` as a cache of s_eff: padded
    with zeros when S < s_eff; else the last s_eff entries, rolled by S % s_eff so
    that position p sits at slot p % s_eff (decode's write invariant)."""
    s = t.shape[dim]
    if s_eff > s:
        pad = [0, 0] * (t.ndim - 1 - dim) + [0, s_eff - s]
        return F.pad(t, pad)
    if s_eff < s:
        t = t.narrow(dim, s - s_eff, s_eff)
        shift = s % s_eff
        if shift:
            t = torch.roll(t, shift, dims=dim)
    return t


def prefill(params: DenseLM, cfg: ModelConfig, tokens: torch.Tensor, s_max: int | None = None,
            policy: ExecutionPolicy | None = None):
    """Run the stack over the prompt: (last-position logits (B, 1, V) float32, DecodeState).

    The caches are padded out to s_max; a local slot keeps the last `window`
    entries, rolled so that position p sits at slot p % S_eff (decode's
    invariant).
    """
    check_transformer(cfg)
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
        h = hint_residual(h)
        kvs[i % g].append(kv)
    h = params.final_norm(h)
    logits = (h[:, -1:] @ lm_head_weights(params, cfg)).to(torch.float32)

    caches = []
    for slot, slot_type in enumerate(cfg.layer_pattern):
        k = torch.stack([kv[0] for kv in kvs[slot]])  # (n_groups, B, S, Hkv, Dh)
        v = torch.stack([kv[1] for kv in kvs[slot]])
        s_eff = _s_eff(cfg, slot_type, s_max)
        k, v = fit_cache(k, s_eff, dim=2), fit_cache(v, s_eff, dim=2)
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
    check_transformer(cfg)
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
