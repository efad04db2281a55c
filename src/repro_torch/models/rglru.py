"""RG-LRU (Real-Gated Linear Recurrent Unit), Griffin / recurrentgemma
(arXiv:2402.19427).

    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    a_t = a^(c * r_t)       a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX package's `models/rglru.py`.  Train/prefill: a log-depth scan over
the sequence (`lru_scan`, ceil(log2 S) steps of plain torch ops, where the
reference has `jax.lax.associative_scan`: the same recurrence, associated
in another order, so its tests state a float tolerance).  Decode: the O(1)
state update.
The recurrent block wraps the RG-LRU with linear in-projections, a short
causal conv and a gated output, per the Griffin paper; every linear runs
the SC path under an SC policy.  The recurrence is float32.  Nothing here
reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models.layers import ACTS
from repro_torch.models.mamba2 import causal_conv, conv_tail
from repro_torch.models.nn import Linear, draw_normal

_C = 8.0
CONV_WIDTH = 4


class LRUCache(NamedTuple):
    """Decode state of one recurrent layer (or, stacked, of a slot's layers)."""

    h: torch.Tensor  # (B, W) recurrent state, float32
    conv: torch.Tensor  # (B, CONV_WIDTH - 1, W) the last conv inputs


class RGLRU(nn.Module):
    """The reference's `rglru_init` tree: `in_x`, `in_y` (d -> W, no bias),
    `conv_w` (4, W) N(0, 0.01), `conv_b` zeros, `gate_a`, `gate_x` (W -> W, with
    bias), `lam` (float32, so that a = sigmoid(lam)^c spans 0.9-0.999) and
    `out` (W -> d, no bias); W = lru_width or d_model."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        w = cfg.lru_width or d
        dtype = dtype or torch.float32
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.in_x = Linear(d, w, bias=False, **kw)
        self.in_y = Linear(d, w, bias=False, **kw)
        conv = draw_normal(CONV_WIDTH, w, generator=generator, device=device) * 0.1
        self.conv_w = nn.Parameter(conv.to(device=device, dtype=dtype))
        self.conv_b = nn.Parameter(torch.zeros(w, device=device, dtype=dtype))
        self.gate_a = Linear(w, w, bias=True, **kw)
        self.gate_x = Linear(w, w, bias=True, **kw)
        root = torch.linspace(0.9, 0.999, w, dtype=torch.float32) ** (1 / _C)
        self.lam = nn.Parameter(torch.log(root / (1 - root)).to(device))
        self.out = Linear(w, d, bias=False, **kw)

    def forward(self, x: torch.Tensor, cache: LRUCache | None = None,
                policy: ExecutionPolicy | None = None):
        """`rglru_apply`: (out, new cache)."""
        return rglru_apply(self, self.cfg, x, cache=cache, policy=policy)


def lru_scan(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t over dim 1 of (B, S, W) float32, h_{-1} = 0.

    Hillis-Steele over (a, b) pairs: at offset d each position combines with
    the one d earlier, (a', b') = (a_{t-d} a_t, b_{t-d} a_t + b_t), for d = 1,
    2, 4, ... < S: ceil(log2 S) steps of whole-tensor ops, where a loop over
    S would launch S small steps a layer.
    """
    s = x.shape[1]
    a_s, b_s = a, x
    d = 1
    while d < s:
        b_s = torch.cat([b_s[:, :d], b_s[:, :-d] * a_s[:, d:] + b_s[:, d:]], dim=1)
        a_s = torch.cat([a_s[:, :d], a_s[:, :-d] * a_s[:, d:]], dim=1)
        d *= 2
    return b_s


def rglru_apply(p: RGLRU, cfg: ModelConfig, x: torch.Tensor, cache: LRUCache | None = None,
                policy: ExecutionPolicy | None = None):
    """x: (B, S, d_model) -> (out, new cache).  The Griffin recurrent block, train or
    prefill (cache None) or decode (S == 1)."""
    gate_branch = ACTS["gelu"](p.in_y(x, policy=policy))  # (B, S, W), jax.nn.gelu's tanh form
    u = p.in_x(x, policy=policy)  # (B, S, W)

    if cache is None:  # short causal conv (depthwise, width 4)
        uc = causal_conv(u, p.conv_w, p.conv_b)
        tail = conv_tail(u, p.conv_w.shape[0])
    else:
        hist = torch.cat([cache.conv, u], dim=1)  # (B, W, C)
        uc = (torch.einsum("bwc,wc->bc", hist, p.conv_w) + p.conv_b)[:, None]
        tail = hist[:, 1:]

    # the RG-LRU core, float32
    ucf = uc.to(torch.float32)
    r = torch.sigmoid(p.gate_a(uc, policy=policy).to(torch.float32))
    i = torch.sigmoid(p.gate_x(uc, policy=policy).to(torch.float32))
    log_a = _C * r * F.logsigmoid(p.lam)[None, None, :]
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * ucf)

    if cache is None:
        h = lru_scan(gated_in, a)  # (B, S, W)
        new_cache = LRUCache(h=h[:, -1], conv=tail)
    else:
        h = a[:, 0] * cache.h + gated_in[:, 0]  # (B, W)
        new_cache = LRUCache(h=h, conv=tail)
        h = h[:, None]

    out = p.out(h.to(x.dtype) * gate_branch, policy=policy)
    return out, new_cache
