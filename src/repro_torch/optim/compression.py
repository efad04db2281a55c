"""Int8 gradient compression with error feedback (the cross-pod all-reduce path).

At multi-pod scale the gradient all-reduce crosses the slow link between
pods; int8 cuts that traffic 4x against float32.  Error feedback (the
residual carried between steps) keeps the quantization noise unbiased in
the limit, so SGD and Adam converge on the same schedule.

Usage inside a train step:
    cgrads, new_err = compress_grads(grads, err)        # int8 + scales
    # all-reduce / accumulate cgrads (int32-safe)
    grads = decompress_grads(cgrads)

A tree here is a module (its parameters under their reference names,
`params.named_jax_params`) or a dict {name: tensor}; the outputs are dicts
under the same names.  Each leaf's scale is a float32 tensor on its
device, and every divisor lies on the data's device (`core/quant.py` says
why), so the bits equal the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.params import named_jax_params


class CompressedTree(NamedTuple):
    """Per-leaf int8 values and their float32 scales, keyed like the gradient tree."""

    q: dict  # name -> int8 tensor
    scale: dict  # name -> float32 scalar tensor


def _named(tree) -> dict:
    if isinstance(tree, torch.nn.Module):
        return named_jax_params(tree)
    return dict(tree)


def init_error_feedback(params) -> dict:
    """Zero float32 residuals shaped like each parameter, on its device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in _named(params).items()}


def compress_grads(grads, err_feedback) -> tuple[CompressedTree, dict]:
    """Quantize (g + err) to int8 per leaf, symmetric; return (compressed, new residual).

    scale = max(|x|, 1e-12) / 127 and q = clip(round(x / scale), -127, 127),
    rounding half to even; the residual is x - q * scale.
    """
    grads, err = _named(grads), _named(err_feedback)
    q, scale, new_err = {}, {}, {}
    for k, g in grads.items():
        x = g.detach().to(torch.float32) + err[k]
        qmax = torch.full((), 127.0, dtype=torch.float32, device=x.device)
        s = torch.clamp(x.abs().amax(), min=1e-12) / qmax
        qk = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        q[k], scale[k] = qk, s
        new_err[k] = x - qk.to(torch.float32) * s
    return CompressedTree(q=q, scale=scale), new_err


def decompress_grads(c: CompressedTree) -> dict:
    """float32 gradients back from int8 values and their scales: q * scale."""
    return {k: q.to(torch.float32) * c.scale[k] for k, q in c.q.items()}
