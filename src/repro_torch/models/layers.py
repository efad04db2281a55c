"""Shared transformer primitives of the dense LMs: RMSNorm, RoPE, GQA attention
(train/prefill and decode, float and int8 KV caches), block-pair flash
attention, and the GLU and dense MLPs.

The JAX package's `models/layers.py`:

* `flash_attention` walks the same statically enumerated (q block, kv
  block) pairs (`_pick_block`, `_flash_geometry`): causal and windowed
  patterns visit only the pairs they need, and the (S, S) scores are never
  built.  Each q block keeps its running max, denominator and accumulator in
  float32 (the online softmax, masked scores at -2e38, the 1e-20 floor);
  its pairs come row-major as in the reference's scan, so every block sees
  the same sequence of updates.  The forward also gives the log-sum-exp,
  and the backward is the reference's `custom_vjp` (`_FlashCore`, FA2):
  it keeps only (q, k, v, out, lse) and recomputes each pair's
  probabilities from them.  Plain torch ops, layout (B, S, H, Dh) at the
  boundary: the reference's is pure JAX too, no Pallas kernel.
* Decode attends one query against a cache: dense O(S) row attention.  The
  int8 cache keeps per-(token, head) scales, which factor out of both
  contractions.
* GQA: q heads are grouped over kv heads by a reshape, as the reference's
  einsums do.

Every product that the reference asks for in float32
(`preferred_element_type`) is done here on float32 copies of its operands:
the products of two bf16 values are exact in float32, so only the order of
the sum differs.  Nothing here reads a value back to the host or builds a
tensor from host data: `cache_len` and `write_idx` stay device tensors, so
a decode step can be captured as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import accounting
from repro_torch.core.overrides import overridable
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models.nn import Linear

_NEG_INF = -2.0e38
_CONTIGUOUS = torch.contiguous_format

# jax.nn.gelu is the tanh approximation by default (0.841192 at 1.0 against
# the exact 0.841345), so gelu here is too.
ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """RMSNorm with float32 statistics and scale, cast back to the input's dtype."""

    def __init__(self, d: int, *, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x * rsqrt(mean(x^2) + eps) * g over the last dim, in float32."""
        x32 = x.to(torch.float32)
        y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.g.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """(d_head / 2,) float32 inverse frequencies theta^(-2i / d_head)."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x (..., S, H, Dh) by positions (..., S): float32 angles, split halves."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash attention over static block pairs
# ---------------------------------------------------------------------------


def _block_pairs(nb: int, causal: bool, window_blocks: int | None) -> list[tuple[int, int]]:
    """Statically enumerate the needed (q_block, kv_block) pairs, row-major."""
    pairs = []
    for i in range(nb):
        lo = 0 if window_blocks is None else max(0, i - window_blocks)
        hi = i if causal else nb - 1
        for j in range(lo, hi + 1):
            pairs.append((i, j))
    return pairs


def _pick_block(n: int, want: int) -> int:
    blk = min(want, n)
    if n % blk:
        for cand in (256, 128, 64, 32, 16, 8, 4, 2, 1):
            if n % cand == 0:
                return cand
    return blk


def _flash_geometry(s: int, sk: int, causal: bool, window, block: int):
    blk = _pick_block(math.gcd(s, sk), block)
    nb, nkb = s // blk, sk // blk
    wb = None if window is None else max(1, (window + blk - 1) // blk)
    if causal:
        pairs = _block_pairs(nb, True, wb)
    else:
        pairs = [(i, j) for i in range(nb) for j in range(nkb)]
    return blk, pairs


def _pair_mask(i: int, j: int, blk: int, causal: bool, window, device) -> torch.Tensor:
    span = torch.arange(blk, device=device)
    qpos = i * blk + span[:, None]
    kpos = j * blk + span[None, :]
    mask = torch.ones((blk, blk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def _flash_forward(q, k, v, causal: bool, window, blk: int, pairs, scale: float):
    """q (B, Hq, S, Dh), k/v (B, Hkv, Skv, Dh) -> (out (B, Hq, S, Dh) float32,
    lse (B, Hq, S, 1) float32), the reference's `_flash_fwd_impl`."""
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kf = k.to(torch.float32)
    # the buffers are made like q (or a slice of it), so a split q splits them alike
    out = torch.empty_like(q, dtype=torch.float32, memory_format=_CONTIGUOUS)
    lse = torch.empty_like(q[..., :1], dtype=torch.float32, memory_format=_CONTIGUOUS)
    by_row: dict[int, list[int]] = {}
    for i, j in pairs:
        by_row.setdefault(i, []).append(j)
    # every row, and every pair, dispatches the same ops: on meta (shapes alone)
    # the first of each stands for all (`core.accounting.loop`)
    short = q.is_meta
    inner = Fraction(len(pairs), len(by_row)) if short else None
    for i, cols in accounting.loop(by_row.items(), short):
        rows = slice(i * blk, (i + 1) * blk)
        # q * scale in q's dtype, then the product in float32
        qi = (q[:, :, rows] * scale).reshape(b, hkv, g, blk, dh).to(torch.float32)
        q_rows = q[:, :, rows]
        m = torch.full_like(q_rows[..., :1], _NEG_INF, dtype=torch.float32,
                            memory_format=_CONTIGUOUS)
        den = torch.zeros_like(q_rows[..., :1], dtype=torch.float32, memory_format=_CONTIGUOUS)
        acc = torch.zeros_like(q_rows, dtype=torch.float32, memory_format=_CONTIGUOUS)
        for j in accounting.loop(cols, short, inner):
            keys = slice(j * blk, (j + 1) * blk)
            scores = torch.matmul(qi, kf[:, :, None, keys].transpose(-1, -2))
            mask = _pair_mask(i, j, blk, causal, window, q.device)
            scores = torch.where(mask, scores, _NEG_INF).reshape(b, hq, blk, blk)
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            safe_m = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
            # masked scores are -2e38: exp underflows to exactly 0
            p = torch.exp(scores - safe_m)
            corr = torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(m - safe_m))
            den = corr * den + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(
                p.reshape(b, hkv, g, blk, blk).to(v.dtype).to(torch.float32),
                v[:, :, None, keys].to(torch.float32),
            ).reshape(b, hq, blk, dh)
            acc = corr * acc + pv
            m = m_new
            # nothing of a pair outlives it: each pair holds what the first does
            del scores, mask, m_new, safe_m, p, corr, pv
        floored = torch.clamp(den, min=1e-20)
        out[:, :, rows] = acc / floored
        lse[:, :, rows] = torch.where(den > 0, m + torch.log(floored), _NEG_INF)
        del q_rows, qi, m, den, acc, floored
    return out, lse


def _flash_backward(dout, q, k, v, out, lse, causal: bool, window, blk: int, pairs,
                    scale: float):
    """The reference's `_flash_core_bwd`: (dq, dk, dv) in q's, k's and v's dtypes.

    FA2: p is recomputed a pair at a time from (q, k, lse), in the forward's
    row-major pair order, so nothing of size (S, S) is ever held; dk and dv
    sum over the g query heads of their kv head.  Accumulated in float32.
    """
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dout = dout.to(torch.float32)
    dvec = (dout * out).sum(dim=-1, keepdim=True)  # D_i = rowsum(dO * O)  (B, Hq, S, 1)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dq = torch.zeros_like(q, dtype=torch.float32, memory_format=_CONTIGUOUS)
    dk = torch.zeros_like(k, dtype=torch.float32, memory_format=_CONTIGUOUS)
    dv = torch.zeros_like(dk)
    for i, j in accounting.loop(pairs, q.is_meta):  # on meta one pair stands for all
        rows, keys = slice(i * blk, (i + 1) * blk), slice(j * blk, (j + 1) * blk)
        qi = q[:, :, rows]
        qi_g = (qi * scale).reshape(b, hkv, g, blk, dh).to(torch.float32)
        scores = torch.matmul(qi_g, kf[:, :, None, keys].transpose(-1, -2))
        mask = _pair_mask(i, j, blk, causal, window, q.device)
        scores = torch.where(mask, scores, _NEG_INF)  # the single mask pass
        lsei = lse[:, :, rows].reshape(b, hkv, g, blk, 1)
        safe_lse = torch.where(lsei <= _NEG_INF / 2, 0.0, lsei)
        p = torch.exp(scores - safe_lse)  # masked -> exp underflows to exactly 0
        doi = dout[:, :, rows].reshape(b, hkv, g, blk, dh)
        # dV_j += P^T dO, summed over the q block and the group: one product over g * blk
        dv[:, :, keys] += torch.matmul(p.permute(0, 1, 4, 2, 3).reshape(b, hkv, blk, g * blk),
                                       doi.reshape(b, hkv, g * blk, dh))
        dp = torch.matmul(doi, vf[:, :, None, keys].transpose(-1, -2))  # dP = dO V^T
        ds = p * (dp - dvec[:, :, rows].reshape(b, hkv, g, blk, 1))
        # dQ_i += dS K * scale;  dK_j += dS^T Q * scale
        dq[:, :, rows] += (torch.matmul(ds, kf[:, :, None, keys]) * scale).reshape(b, hq, blk, dh)
        qf = qi.reshape(b, hkv, g, blk, dh).to(torch.float32)
        dk[:, :, keys] += torch.matmul(ds.permute(0, 1, 4, 2, 3).reshape(b, hkv, blk, g * blk),
                                       qf.reshape(b, hkv, g * blk, dh)) * scale
        del qi_g, scores, mask, safe_lse, p, dp, ds, qf  # as in the forward's pairs
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashCore(torch.autograd.Function):
    """The reference's `custom_vjp` `_flash_core`: forward and FA2 backward over
    static block pairs.  It saves (q, k, v, out, lse), O(S * Dh), and never an
    (S, S) block: the forward's per-pair probabilities are not kept."""

    @staticmethod
    def forward(ctx, q, k, v, geometry):
        """(B, H, S, Dh) q, k, v -> out (B, Hq, S, Dh) float32; `geometry` is
        (causal, window, blk, pairs, scale)."""
        out, lse = _flash_forward(q, k, v, *geometry)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geometry = geometry
        return out

    @staticmethod
    def backward(ctx, dout):
        """(dq, dk, dv, None) from the saved residuals."""
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward(dout, q, k, v, out, lse, *ctx.geometry), None)


@overridable
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    block: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """q: (B, S, Hq, Dh), k/v: (B, Skv, Hkv, Dh) -> (B, S, Hq, Dh) in q's dtype.

    Blockwise online-softmax attention over the reference's static list of
    (q, kv) block pairs, with its FA2 backward (`_FlashCore`).
    """
    b, s, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} q heads do not group over {hkv} kv heads")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if causal and s != sk:
        raise ValueError("causal flash attention requires q_len == kv_len")
    blk, pairs = _flash_geometry(s, sk, causal, window, block)
    out = _FlashCore.apply(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                           (causal, window, blk, tuple(pairs), scale))
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention against a cache
# ---------------------------------------------------------------------------


def _as_len(cache_len, device) -> torch.Tensor:
    """cache_len as a (B or 1, 1) tensor; a tensor stays on its device, untouched."""
    if not torch.is_tensor(cache_len):
        cache_len = torch.full((), int(cache_len), dtype=torch.int32, device=device)
    return cache_len.reshape(-1, 1)


def _valid(s: int, cache_len, window: int | None, device) -> torch.Tensor:
    """(B or 1, S) mask of the cache positions a decode step attends to."""
    pos = torch.arange(s, device=device)[None]
    n = _as_len(cache_len, device)
    valid = pos < n
    if window is not None:
        valid = valid & (pos >= n - window)
    return valid


@overridable
def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    cache_len,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-position attention against a cache.

    q: (B, 1, Hq, Dh); k/v_cache: (B, S, Hkv, Dh); positions >= cache_len
    (an int, or a tensor of shape () or (B,)) are masked.  Returns
    (B, 1, Hq, Dh) in q's dtype.
    """
    b, s, hkv, dh = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = (q[:, 0] * scale).reshape(b, hkv, g, dh).to(torch.float32)
    scores = torch.matmul(qg, k_cache.permute(0, 2, 3, 1).to(torch.float32))  # (B, Hkv, g, S)
    valid = _valid(s, cache_len, window, q.device)
    scores = torch.where(valid[:, None, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(v_cache.dtype).to(torch.float32),
                       v_cache.permute(0, 2, 1, 3).to(torch.float32)).to(v_cache.dtype)
    return out.reshape(b, 1, hq, dh).to(q.dtype)


class KVCache(NamedTuple):
    """Float KV cache of one layer: k, v (B, S_max, Hkv, Dh)."""

    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """Int8 KV cache of one layer, with per-(token, head) symmetric scales.

    Dequantisation happens inside the attention reads, so memory only ever
    holds int8 values and the small scales.
    """

    k: torch.Tensor  # (B, S_max, Hkv, Dh) int8
    v: torch.Tensor  # int8
    ks: torch.Tensor  # (B, S_max, Hkv, 1) float32
    vs: torch.Tensor


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) float -> (int8 values, float32 per-(token, head) scales (B, S, H, 1))."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values and their scales back to `dtype`."""
    return (q.to(torch.float32) * scale).to(dtype)


@overridable
def decode_attention_quant(
    q: torch.Tensor,
    cache: QuantKVCache,
    *,
    cache_len,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention over an int8 cache, the scales factored out of both contractions.

        scores[s] = (q . k_q[s]) * ks[s]
        out[d]    = sum_s (p[s] * vs[s]) * v_q[s, d]
    """
    b, s, hkv, dh = cache.k.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = (q[:, 0].to(torch.float32) * scale).reshape(b, hkv, g, dh)
    scores = torch.matmul(qg, cache.k.permute(0, 2, 3, 1).to(torch.float32))
    scores = scores * cache.ks[..., 0].transpose(1, 2)[:, :, None, :]  # (B, Hkv, 1, S)
    valid = _valid(s, cache_len, window, q.device)
    scores = torch.where(valid[:, None, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)  # (B, Hkv, g, S)
    p_scaled = p * cache.vs[..., 0].transpose(1, 2)[:, :, None, :]
    out = torch.matmul(p_scaled, cache.v.permute(0, 2, 1, 3).to(torch.float32))
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cache (B, S, ...) with new (B, 1, ...) at position idx, clamped to [0, S - 1]
    as `jax.lax.dynamic_update_slice_in_dim` clamps its start; out of place."""
    if not torch.is_tensor(idx):
        idx = torch.full((), int(idx), dtype=torch.int64, device=cache.device)
    at = torch.clamp(idx.reshape(1).to(torch.int64), 0, cache.shape[1] - 1)
    return cache.index_copy(1, at, new.to(cache.dtype))


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Geometry and options of one attention block."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    window: int | None = None  # sliding window (None = global)
    causal: bool = True
    use_bias: bool = False
    qk_norm: bool = False


class Attention(nn.Module):
    """GQA self-attention: wq, wk, wv, wo (the reference's `attn_init` tree), RoPE,
    optional q/k RMSNorm; flash attention without a cache, decode against one."""

    def __init__(self, cfg: AttnConfig, *, generator: torch.Generator | None = None,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(bias=cfg.use_bias, generator=generator, device=device, dtype=dtype)
        self.wq = Linear(d, h * dh, **kw)
        self.wk = Linear(d, hk * dh, **kw)
        self.wv = Linear(d, hk * dh, **kw)
        self.wo = Linear(h * dh, d, **kw)
        if cfg.qk_norm:
            self.qnorm = RMSNorm(dh, device=device, dtype=dtype)
            self.knorm = RMSNorm(dh, device=device, dtype=dtype)
        else:
            self.qnorm = self.knorm = None

    def forward(
        self,
        x: torch.Tensor,
        *,
        positions: torch.Tensor,
        cache: KVCache | QuantKVCache | None = None,
        write_idx: torch.Tensor | None = None,
        attend_len=None,
        kv_override=None,
        collect_kv: bool = False,
        decode_window: int | None = None,
        attn_block: int = 512,
        policy: ExecutionPolicy | None = None,
    ):
        """x: (B, S, D) -> (out (B, S, D), aux).

        Without a cache (train/prefill) it runs flash attention, and aux is
        the fresh (k, v) when `collect_kv`, else None.  With one (decode,
        S == 1) it writes the new K/V at `write_idx` (a device tensor, clamped
        to the cache as the reference's update is), attends over
        `attend_len` entries, and aux is the new cache: an int8 cache takes
        the quantized K/V.  Rolling local-window caches pass write_idx = pos %
        window and attend_len = min(pos + 1, window).

        `kv_override` (cross-attention, the encdec decoder's): k and v come
        from wk / wv of kv_override[0], (B, S_kv, D), or, where kv_override
        is a KVCache, are its already projected (B, S_kv, Hkv, Dh) entries
        (the decoder's cross cache); no RoPE on either side and no cache
        write.  S == 1 attends over all S_kv entries as decode does, longer
        queries run non-causal flash attention with no window.  aux is then
        the projected (k, v) when `collect_kv`, else None.
        """
        cfg = self.cfg
        b, s, _ = x.shape
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q = self.wq(x, policy=policy).reshape(b, s, h, dh)
        if isinstance(kv_override, KVCache):
            k, v = kv_override
            if self.qnorm is not None:
                q = self.qnorm(q)
        else:
            src = x if kv_override is None else kv_override[0]
            sk = src.shape[1]
            k = self.wk(src, policy=policy).reshape(b, sk, hk, dh)
            v = self.wv(src, policy=policy).reshape(b, sk, hk, dh)
            if self.qnorm is not None:
                q = self.qnorm(q)
                k = self.knorm(k)
        if kv_override is not None:
            sk = k.shape[1]
            if s == 1:
                out = decode_attention(q, k, v, cache_len=sk)
            else:
                out = flash_attention(q, k, v, causal=False, window=None, block=attn_block)
            aux = (k, v) if collect_kv else None
            return self.wo(out.reshape(b, s, h * dh), policy=policy), aux
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

        aux = None
        if cache is not None:
            if isinstance(cache, QuantKVCache):
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                aux = QuantKVCache(_write(cache.k, kq, write_idx), _write(cache.v, vq, write_idx),
                                   _write(cache.ks, ks, write_idx),
                                   _write(cache.vs, vs, write_idx))
                out = decode_attention_quant(q, aux, cache_len=attend_len, window=decode_window)
            else:
                aux = KVCache(_write(cache.k, k, write_idx), _write(cache.v, v, write_idx))
                out = decode_attention(q, aux.k, aux.v, cache_len=attend_len,
                                       window=decode_window)
        else:
            out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                                  block=attn_block)
            if collect_kv:
                aux = (k, v)
        return self.wo(out.reshape(b, s, h * dh), policy=policy), aux


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class GLUMLP(nn.Module):
    """Gated MLP: wo(act(wg x) * wi x)."""

    def __init__(self, d_model: int, d_ff: int, *, bias: bool = False, act: str = "silu",
                 generator: torch.Generator | None = None, device=None, dtype=None):
        super().__init__()
        self.act = act
        kw = dict(bias=bias, generator=generator, device=device, dtype=dtype)
        self.wi = Linear(d_model, d_ff, **kw)
        self.wg = Linear(d_model, d_ff, **kw)
        self.wo = Linear(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor, policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """(..., d_model) -> (..., d_model)."""
        gate = ACTS[self.act](self.wg(x, policy=policy))
        return self.wo(gate * self.wi(x, policy=policy), policy=policy)


class DenseMLP(nn.Module):
    """Two-layer MLP: wo(act(wi x))."""

    def __init__(self, d_model: int, d_ff: int, *, bias: bool = True, act: str = "gelu",
                 generator: torch.Generator | None = None, device=None, dtype=None):
        super().__init__()
        self.act = act
        kw = dict(bias=bias, generator=generator, device=device, dtype=dtype)
        self.wi = Linear(d_model, d_ff, **kw)
        self.wo = Linear(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor, policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """(..., d_model) -> (..., d_model)."""
        return self.wo(ACTS[self.act](self.wi(x, policy=policy)), policy=policy)
