"""Top-k routed mixture-of-experts FFN (dbrx 16e/top-4, granite 40e/top-8).

The JAX package's `models/moe.py`.  Dispatch is capacity-based
gather/scatter, as there:

  router logits -> top-k experts per token -> per-(expert, k-slot) priority
  rank via cumsum -> tokens beyond capacity C = round(S*k/E * cf) are
  DROPPED -> gather (E, C, d) -> batched expert GLU over stacked (E, d, ff)
  weights -> weighted sum back, slot by slot.

Each batch row is a routing group (the reference `vmap`s over it), so the
capacity rank counts within a row, and under an SC policy each row's router
activations take their own quantization scale; one SC matmul serves every
row.  The order of every step follows the reference where it changes an
answer:

* top-k is a stable descending sort, so equal probabilities keep the lower
  expert first, as `jax.lax.top_k` does (`torch.topk` promises no order);
* the capacity rounds half to even (Python's `round`) and comes from shapes
  alone, so nothing is read back to the host;
* the k contributions of a token are summed in slot order onto zeros, the
  reference's `.at[token].add` order (an `index_add_` would sum in an order
  that varies on the card).

The experts are plain batched products (`torch.bmm`), as the reference's
are `jnp.einsum`s: no SC path, no kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quant import quantize_symmetric
from repro_torch.kernels.sc_matmul.ops import sc_matmul_op
from repro_torch.models.layers import ACTS
from repro_torch.models.nn import Linear, draw_normal


class MoE(nn.Module):
    """The reference's `moe_init` tree: `router` (a float32 Linear d -> E, no bias),
    `wi`, `wg` (E, d, ff) and `wo` (E, ff, d) in `dtype`, N(0, 1/fan_in)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        dtype = dtype or torch.float32
        def normal(*shape, fan_in: int):
            t = draw_normal(*shape, generator=generator, device=device) * (1.0 / math.sqrt(fan_in))
            return nn.Parameter(t.to(device=device, dtype=dtype))

        self.router = Linear(d, e, bias=False, generator=generator, device=device,
                             dtype=torch.float32)
        self.wi = normal(e, d, f, fan_in=d)
        self.wg = normal(e, d, f, fan_in=d)
        self.wo = normal(e, f, d, fan_in=f)

    def forward(self, x: torch.Tensor, policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """(B, S, d) -> (B, S, d): `moe_apply`."""
        return moe_apply(self, self.cfg, x, policy=policy)


def router_logits(router: Linear, x: torch.Tensor,
                  policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """(B, S, d) float32 -> (B, S, E) float32 logits, each batch row a routing group.

    Float: x @ w.  Under an SC policy each row's activations are quantized
    with their own scale, as the reference's router is inside its `vmap`
    over the rows, and the rows go through one SC matmul (its integer sums
    do not depend on the scale); each row's sums are then scaled by its own
    scale times the weight's.
    """
    bits = None if policy is None else policy.quant_bits
    if bits is None:
        return router(x, policy=policy)
    b, s, d = x.shape
    xq = quantize_symmetric(x, bits, axis=(1, 2))  # scale (B, 1, 1)
    wq = quantize_symmetric(router.w, bits)
    y = sc_matmul_op(xq.q.reshape(b * s, d), wq.q, bits=bits, backend=policy.resolved_backend())
    return (y.reshape(b, s, -1) * (xq.scale * wq.scale)).to(torch.float32)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows of idx over n classes, by comparison: F.one_hot checks its
    input's range on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int64)


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots an expert has in a routing group of s tokens: round(s * k / E * cf),
    at least 1; Python's round, half to even."""
    return int(max(1, round(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def route(cfg: ModelConfig, logits: torch.Tensor) -> tuple:
    """Routing of (B, S, E) logits: (buf_row, buf_col, top_p, keep), each (B, S * k)
    in (token, slot) order.

    A token's k experts are its k largest probabilities, ties to the lower
    expert; their weights are renormalised to sum to one.  rank = how many
    earlier (token, slot) pairs of its row chose the same expert; a pair at
    rank >= capacity is dropped into the scratch row E, column 0.
    """
    b, s, e = logits.shape
    k = cfg.top_k
    cap = capacity(cfg, s)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(b, s * k)
    rank_in_e = torch.cumsum(_one_hot(flat_e, e), dim=1) - 1
    my_rank = torch.gather(rank_in_e, 2, flat_e[..., None])[..., 0]
    keep = my_rank < cap
    buf_row = torch.where(keep, flat_e, e)
    buf_col = torch.where(keep, my_rank, 0)
    return buf_row, buf_col, top_p.reshape(b, s * k), keep


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              policy: ExecutionPolicy | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Capacity-dropped top-k routing, each batch row a group."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    buf_row, buf_col, w_flat, keep = route(cfg, router_logits(p.router, x.to(torch.float32),
                                                              policy))
    rows = torch.arange(b, device=x.device)[:, None]
    token_of = torch.arange(s * k, device=x.device) // k  # (S * k,): token t, k times
    # every dropped pair lands on scratch row e, column 0, which is cut off
    expert_in = x.new_zeros((b, e + 1, cap, d)).index_put(
        (rows, buf_row, buf_col), x[:, token_of])[:, :e]

    # batched expert GLU over the stacked weights: (E, B * C, d) rows an expert
    xe = expert_in.permute(1, 0, 2, 3).reshape(e, b * cap, d)
    hidden = ACTS[cfg.act](torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wi)
    expert_out = torch.bmm(hidden, p.wo).reshape(e, b, cap, d).permute(1, 0, 2, 3)

    gathered = expert_out[rows, buf_row.clamp(0, e - 1), buf_col]  # (B, S * k, d)
    w = (w_flat * keep).to(x.dtype)
    contrib = (gathered * w[..., None]).reshape(b, s, k, d)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    for slot in range(k):  # the reference's scatter-add order: slot by slot
        out = out + contrib[:, :, slot]
    return out


def moe_aux_loss(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e, float router."""
    t = x.shape[0] * x.shape[1]
    logits = p.router(x.reshape(t, -1).to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.argmax(probs, dim=-1)  # the first index on ties, as jnp.argmax
    frac = _one_hot(top_e, cfg.n_experts).to(torch.float32).mean(dim=0)
    imp = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * imp)
