"""Uniform per-family LM API (`get_family_api`): the dense family only.

The JAX package's `models/families.py` dispatches six families.  The port
serves and trains `dense` (stablelm-1.6b, starcoder2-3b, gemma3-12b,
command-r-plus-104b); every other family raises NotImplementedError until
its step of ROADMAP.md queue A step 3 lands.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def get_family_api(cfg: ModelConfig) -> dict:
    """{"init", "train_loss", "prefill", "decode_step", "init_decode_state"} of cfg's family.

    `train_loss(params, cfg, batch, policy=None)` reads batch["tokens"] and
    batch["labels"] and returns (loss, metrics); `prefill(params, cfg,
    batch, s_max=None, policy=None)` reads batch["tokens"],
    `decode_step(params, cfg, state, batch, policy=None)` batch["token"],
    as in the reference.
    """
    T.check_dense(cfg)
    return {
        "init": T.init_lm,
        "train_loss": T.lm_loss,
        "prefill": lambda p, c, b, s_max=None, policy=None: T.prefill(
            p, c, b["tokens"], s_max, policy=policy),
        "decode_step": lambda p, c, st, b, policy=None: T.decode_step(
            p, c, st, b["token"], policy=policy),
        "init_decode_state": T.init_decode_state,
    }
