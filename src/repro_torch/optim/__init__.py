"""AdamW with fp32 master weights and moments, the learning-rate schedule, and
int8 gradient compression with error feedback (`compression`, the cross-pod
all-reduce's)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressedTree,
    compress_grads,
    decompress_grads,
    init_error_feedback,
)
from repro_torch.optim.schedule import cosine_warmup_schedule  # noqa: F401
