"""LM serving steps: prefill and batched greedy decode (`make_serve_fns`).

The JAX package's `serve/step.py`.  `make_serve_fns(cfg, policy=...)` pins
every step to one ExecutionPolicy (float, or the SC W16A16/W8A8 integer
path for every linear of the LM); policy=None takes the config's default.
Policies are plain arguments, so servers holding different policies share
nothing.  The steps run where `device` says (the card unless the caller
names another): token arrays are moved there, and the params must be there.
A prefill batch may carry the stubbed frontends' outputs, `enc_embeds`
(encdec) and `patch_embeds` (vlm); they move there in their own dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models.families import get_family_api


def _tokens_on(x, device: torch.device) -> torch.Tensor:
    """Token ids (numpy or torch) as an int32 tensor on `device`."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, dtype=np.int32))  # a writable copy
    return x.to(device=device, dtype=torch.int32)


# float inputs of a prefill batch, beside its tokens: the stubbed frontends' outputs
EMBED_KEYS = ("enc_embeds", "patch_embeds")


def _floats_on(x, device: torch.device) -> torch.Tensor:
    """A numpy or torch float array as a tensor on `device`, in its own dtype."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))  # a writable copy
    return x.to(device=device)


def make_serve_fns(cfg: ModelConfig, policy: ExecutionPolicy | None = None, *, device=None):
    """Serving closures {"prefill", "decode", "generate"} for one LM config.

    prefill(params, batch, s_max) -> (logits (B, 1, V) float32, decode state);
    decode(params, state, batch) -> (logits, next token (B, 1) int32, state);
    generate(params, batch, steps=, s_max=) -> (B, steps) int32 greedy tokens.
    Greedy tokens are the first index of the largest logit, as jnp.argmax
    gives them.  The steps record no autograd graph (serving needs none).
    """
    api = get_family_api(cfg)
    policy = resolve_policy(cfg, policy)
    dev = resolve_device(device)

    def _check(params):
        if params.embed.device != dev:
            raise ValueError(f"params lie on {params.embed.device}, the serve fns on {dev}")

    def prefill_step(params, batch, s_max: int):
        _check(params)
        inputs = {"tokens": _tokens_on(batch["tokens"], dev)}
        inputs.update((k, _floats_on(batch[k], dev)) for k in EMBED_KEYS if k in batch)
        with torch.no_grad():
            return api["prefill"](params, cfg, inputs, s_max, policy=policy)

    def decode_step(params, state, batch):
        """One token for the whole batch, with the greedy next token."""
        _check(params)
        with torch.no_grad():
            logits, state = api["decode_step"](params, cfg, state,
                                               {"token": _tokens_on(batch["token"], dev)},
                                               policy=policy)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return logits, next_tok, state

    def generate(params, batch, *, steps: int, s_max: int):
        """Greedy autoregressive generation."""
        logits, state = prefill_step(params, batch, s_max)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(steps - 1):
            _, tok, state = decode_step(params, state, {"token": tok})
            out.append(tok)
        return torch.cat(out, dim=1)

    return {"prefill": prefill_step, "decode": decode_step, "generate": generate}
