"""AdamW with fp32 master weights and moments, and the learning-rate schedule.

The JAX package's `optim/compression.py` (int8 gradient compression for the
cross-pod all-reduce) waits for multi-device (ROADMAP.md, queue A item 10).
"""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import cosine_warmup_schedule  # noqa: F401
