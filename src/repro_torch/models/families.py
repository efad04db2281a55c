"""Uniform per-family LM API (`get_family_api`): the dense family only.

The JAX package's `models/families.py` dispatches six families.  The port
serves `dense` (stablelm-1.6b, starcoder2-3b, gemma3-12b,
command-r-plus-104b); every other family raises NotImplementedError until
its step of ROADMAP.md queue A step 3 lands.  The training loss is not in
the dict yet: it comes with LM training (queue A step 3f).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def get_family_api(cfg: ModelConfig) -> dict:
    """{"init", "prefill", "decode_step", "init_decode_state"} of cfg's family.

    `prefill(params, cfg, batch, s_max=None, policy=None)` reads
    batch["tokens"], `decode_step(params, cfg, state, batch, policy=None)`
    batch["token"], as in the reference.
    """
    T.check_dense(cfg)
    return {
        "init": T.init_lm,
        "prefill": lambda p, c, b, s_max=None, policy=None: T.prefill(
            p, c, b["tokens"], s_max, policy=policy),
        "decode_step": lambda p, c, st, b, policy=None: T.decode_step(
            p, c, st, b["token"], policy=policy),
        "init_decode_state": T.init_decode_state,
    }
