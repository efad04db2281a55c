"""AdamW with fp32 master weights and moments, updating in place.

The JAX package's `optim/adamw.py`, with one difference of form: JAX returns
new arrays, the port writes the new values into the parameter and moment
tensors it was given (under `torch.no_grad()`) and returns those same
tensors.  Two reasons.  A captured training step (`core/graphs.GraphedStep`)
replays over fixed buffers; and the inference artifacts (`core/graphs.py`)
are keyed by the parameters' storage, so a step that made new tensors
would make every `infer` capture again after every step.

A "tree" here is a module (its parameters under their reference names,
`params.named_jax_params`) or a dict {name: tensor}.  The moments and the
master copy are dicts under the same names, so a checkpoint of
{"params": params, "opt": state} has the reference's leaves in the
reference's order (`params.tree_leaves`).

The step count is an int32 tensor on the parameters' device, and the bias
corrections `1 - b ** step` are computed from it on the device in float32,
as the reference does: a graph replay reads the current step.  Clipping
stays on the device too: nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.params import named_jax_params, tree_leaves


class AdamWState(NamedTuple):
    """Optimizer state; each moment dict mirrors the parameter tree."""

    step: torch.Tensor  # int32 scalar
    mu: Any  # first moment (fp32, param-shaped)
    nu: Any  # second moment (fp32)
    master: Any | None  # fp32 master params (None if params already fp32)


def _named(tree) -> dict:
    if isinstance(tree, torch.nn.Module):
        return named_jax_params(tree)
    return dict(tree)


def adamw_init(params, *, keep_master: bool | None = None) -> AdamWState:
    """Zero moments (fp32) beside the parameters, step 0, and a master copy
    only where a parameter is not fp32 (or as `keep_master` says)."""
    named = _named(params)
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named.items()}
    nu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named.items()}
    if keep_master is None:
        keep_master = any(p.dtype != torch.float32 for p in named.values())
    master = ({k: p.detach().to(torch.float32, copy=True) for k, p in named.items()}
              if keep_master else None)
    device = next(iter(named.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=mu, nu=nu,
                      master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in the reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most `max_norm`, the norm before)."""
    norm = global_norm(grads)
    # the divisor on the device: CUDA divides by a host scalar as a product with its reciprocal
    limit = torch.full((), max_norm, dtype=norm.dtype, device=norm.device)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in _named(grads).items()}, norm


def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr: float | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float | None = 1.0,
):
    """Returns (params, state, metrics), the parameters and moments updated in place.

    metrics holds "grad_norm" (before clipping) when `max_grad_norm` is set.
    """
    with torch.no_grad():
        metrics = {}
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            metrics["grad_norm"] = gnorm
        grads = _named(grads)
        state.step.add_(1)
        step = state.step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, step)
        bc2 = 1.0 - torch.pow(b2, step)
        for k, p in _named(params).items():
            g32 = grads[k].to(torch.float32)
            m, v = state.mu[k], state.nu[k]
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            mhat = m / bc1
            vhat = v / bc2
            pm = state.master[k] if state.master is not None else None
            p32 = pm if pm is not None else p.to(torch.float32)
            p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32)
            if pm is not None:
                pm.copy_(p32)
            p.copy_(p32.to(p.dtype))
    return params, state, metrics
