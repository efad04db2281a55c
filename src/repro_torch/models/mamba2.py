"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) blocks.

The JAX package's `models/mamba2.py`.  Train/prefill runs the chunked SSD
algorithm: quadratic attention-like math *within* chunks (Q = ssm_chunk)
and a linear recurrence over chunk states:

  per chunk c:   L = exp(segsum(dtA))            (intra-chunk decay, Q x Q)
                 Y_diag = (C B^T . L) X           (intra-chunk)
                 S_c    = (decay . B)^T X         (chunk state contribution)
  across chunks: S'_c = exp(sum dtA_c) S'_{c-1} + S_c
                 Y_off  = C S'_{c-1} with in-chunk decay

Decode is the O(1) recurrent update  s = exp(dtA) s + dt B x;  y = C s + D x.

Layout: x (B, S, H, P) with H = expand * d_model / headdim heads, state N.
`A_log`, `D` and `dt_bias` are float32 in any model dtype, and the SSD runs
in float32, as in the reference.  The segment sums are the difference of
two cumulative sums (the reference's `_segsum`): a masked sum would round
otherwise.  Plain torch ops, no kernel: the reference's are pure JAX.
Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.overrides import overridable
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models.layers import RMSNorm
from repro_torch.models.nn import Linear, draw_normal


class SSMCache(NamedTuple):
    """Decode state of one layer (or, stacked, of every layer)."""

    state: torch.Tensor  # (B, H, P, N) float32
    conv: torch.Tensor  # (B, W - 1, conv_dim) the last raw conv inputs


def mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, n_heads, conv_dim): x, B and C are all convolved."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba2(nn.Module):
    """The reference's `mamba2_init` tree: `in_proj` (d -> [z, x, B, C, dt], no
    bias), `conv_w` (W, conv_dim) N(0, 0.01), `conv_b` zeros, `A_log` =
    log(linspace(1, 16, H)), `D` ones, `dt_bias` zeros (those three float32),
    `norm` (an RMSNorm over d_inner) and `out_proj` (d_inner -> d, no bias)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, n_heads, conv_dim = mamba2_dims(cfg)
        dtype = dtype or torch.float32
        kw = dict(bias=False, generator=generator, device=device, dtype=dtype)
        self.in_proj = Linear(d, 2 * d_inner + 2 * cfg.ssm_state + n_heads, **kw)
        conv = draw_normal(cfg.ssm_conv, conv_dim, generator=generator, device=device) * 0.1
        self.conv_w = nn.Parameter(conv.to(device=device, dtype=dtype))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=device, dtype=dtype))
        f32 = dict(device=device, dtype=torch.float32)
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)))
        self.D = nn.Parameter(torch.ones(n_heads, **f32))
        self.dt_bias = nn.Parameter(torch.zeros(n_heads, **f32))
        self.norm = RMSNorm(d_inner, device=device, dtype=dtype)
        self.out_proj = Linear(d_inner, d, **kw)

    def forward(self, x: torch.Tensor, cache: SSMCache | None = None,
                policy: ExecutionPolicy | None = None):
        """`mamba2_apply`: (out, new cache, state)."""
        return mamba2_apply(self, self.cfg, x, cache=cache, policy=policy)


@overridable
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C), w: (W, C) -> (B, S, C), in x's dtype:
    the reference's unrolled shift-multiply-add, in its order."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    return out + b[None, None, :]


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last width - 1 raw conv inputs of x (B, S, C), left-padded with zeros when
    S < width - 1: the decode cache's rolling conv state after a prefill."""
    s = x.shape[1]
    if s >= width - 1:
        return x[:, s - (width - 1):]
    return F.pad(x, (0, 0, width - 1 - s, 0))


def segsum(dta: torch.Tensor) -> torch.Tensor:
    """dta: (..., Q) -> (..., Q, Q) lower-triangular sums sum_{j < m <= i} dta_m, -inf
    above the diagonal: the difference of two cumulative sums, as the reference."""
    q = dta.shape[-1]
    cum = torch.cumsum(dta, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # (..., Q, Q): the sum over (j, i]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dta.device))
    return diff.masked_fill(~mask, float("-inf"))


@overridable
def ssd_forward(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD.  x: (b, s, h, p); dt: (b, s, h); A: (h,) (negative); B, C:
    (b, s, n), taken in float32.  Returns (y (b, s, h, p), final state (b, h, p, n)).

    The chunk is min(chunk, s), halved while it does not divide s; the
    inter-chunk recurrence is a loop over the chunks that keeps the state
    *before* each chunk (the reference's `scan`)."""
    x, B, C = x.to(torch.float32), B.to(torch.float32), C.to(torch.float32)
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    dta = dtc * A[None, None, None, :]  # (b, nc, q, h) negative decays

    # intra-chunk ("diagonal") term, weighted by dt at the source position j
    L = torch.exp(segsum(dta.permute(0, 1, 3, 2)))  # (b, nc, h, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (b, nc, q, q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", L * scores[:, :, None],
                          dtc[..., None] * xc)

    # chunk state contributions: S_c = sum_j decay_to_end_j * dt_j * B_j x_j^T
    decay_end = torch.exp(torch.flip(torch.cumsum(torch.flip(dta, [2]), dim=2), [2]) - dta)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, (decay_end * dtc)[..., None] * xc)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(dta.sum(dim=2))  # (b, nc, h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # off-diagonal (cross-chunk) term: decay from the chunk start to position i
    decay_in = torch.exp(torch.cumsum(dta, dim=2))  # (b, nc, q, h)
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, prev_states) * decay_in[..., None]

    return (y_diag + y_off).reshape(b, s, h, p), state


def mamba2_apply(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, cache: SSMCache | None = None,
                 policy: ExecutionPolicy | None = None):
    """x: (B, S, d_model).  Train/prefill (cache None) or decode (S == 1).

    Returns (out (B, S, d_model), new cache, the SSM state): a prefill's
    cache holds the final state and the last W - 1 raw conv inputs."""
    bsz, s, _ = x.shape
    d_inner, n_heads, conv_dim = mamba2_dims(cfg)
    n = cfg.ssm_state
    width = cfg.ssm_conv

    zxbcdt = p.in_proj(x, policy=policy)  # (B, S, 2 d_inner + 2n + H)
    z = zxbcdt[..., :d_inner]  # gate
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]  # x, B, C (convolved)
    dt_raw = zxbcdt[..., d_inner + conv_dim:]  # (B, S, H)

    xbc_raw = xbc
    if cache is None:
        xbc = causal_conv(xbc, p.conv_w, p.conv_b)
    else:  # decode: the rolling conv state (B, W - 1, conv_dim) and this token
        hist = torch.cat([cache.conv, xbc], dim=1)  # (B, W, C)
        xbc = (torch.einsum("bwc,wc->bc", hist, p.conv_w) + p.conv_b)[:, None, :]
        new_conv = hist[:, 1:]
    xbc = F.silu(xbc)

    xs = xbc[..., :d_inner].reshape(bsz, s, n_heads, cfg.ssm_headdim)
    B = xbc[..., d_inner:d_inner + n]
    C = xbc[..., d_inner + n:]
    dt = softplus(dt_raw.to(torch.float32) + p.dt_bias)  # (B, S, H)
    A = -torch.exp(p.A_log)  # (H,) negative

    if cache is None:
        y, state = ssd_forward(xs, dt, A, B, C, chunk=cfg.ssm_chunk)
        new_cache = SSMCache(state=state, conv=conv_tail(xbc_raw, width))
    else:  # the O(1) recurrent step
        dta = torch.exp(dt[:, 0] * A[None, :])  # (B, H)
        sx = xs[:, 0].to(torch.float32)  # (B, H, P)
        dbx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], B[:, 0].to(torch.float32), sx)
        state = cache.state * dta[..., None, None] + dbx
        y = torch.einsum("bn,bhpn->bhp", C[:, 0].to(torch.float32), state)[:, None]
        new_cache = SSMCache(state=state, conv=new_conv)

    y = y + xs.to(torch.float32) * p.D[None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = p.norm(y * F.silu(z))
    return p.out_proj(y, policy=policy), new_cache, state
