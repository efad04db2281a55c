"""Public op: delayed aggregation's gather + masked max-pool via the kernel registry.

One op for what `masked_maxpool(group_features(features, nbrs), nbrs.mask)`
computes: the kernel on CUDA tensors, that composition on CPU tensors.
Under autograd the gradient is the composition's (amax's even split among
tied slots), recomputed in the backward from the saved inputs: no TPU
kernel had a backward here, so the backward is plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.group_pool.kernel import group_maxpool_cuda
from repro_torch.kernels.group_pool.ref import group_maxpool_plain

registry.register("group_maxpool", plain=group_maxpool_plain, cuda=group_maxpool_cuda)


class GroupMaxPool(torch.autograd.Function):
    """`impl`'s forward with the plain composition's gradient."""

    @staticmethod
    def forward(ctx, impl, features, idx, mask):
        """impl(features, idx, mask); the inputs are saved for the backward."""
        ctx.save_for_backward(features, idx, mask)
        return impl(features, idx, mask)

    @staticmethod
    def backward(ctx, grad):
        """Autograd through the plain composition, recomputed from the saved inputs.

        The gradient of the gather, the where and amax's split among ties,
        as without the op.
        """
        features, idx, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaf = features.detach().requires_grad_()
            out = group_maxpool_plain(leaf, idx, mask)
        (g,) = torch.autograd.grad(out, leaf, grad)
        return None, g, None, None


def group_maxpool(
    features: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, *,
    backend: str | None = "auto",
) -> torch.Tensor:
    """features (..., N, C), idx (..., M, S) int32, mask (..., M, S) bool -> (..., M, C).

    Per centroid, the max over its valid neighbours' feature rows (padded
    slots ignored; a centroid with no valid neighbour gets 0).  The leading
    dims are flattened into one batch axis, the kernel's grid axis.
    """
    lead = features.shape[:-2]
    if (features.ndim < 2 or idx.shape != mask.shape or idx.ndim != features.ndim
            or idx.shape[:-2] != lead):
        raise ValueError(
            f"expected features (..., N, C), idx and mask (..., M, S) with the same leading "
            f"dims, got {tuple(features.shape)}, {tuple(idx.shape)} and {tuple(mask.shape)}"
        )
    impl = registry.dispatch("group_maxpool", features, backend)
    rows = math.prod(lead)
    n, c = features.shape[-2:]
    m, s = idx.shape[-2:]
    args = (features.reshape(rows, n, c).contiguous(), idx.reshape(rows, m, s).contiguous(),
            mask.reshape(rows, m, s).contiguous())
    if torch.is_grad_enabled() and features.requires_grad:
        out = GroupMaxPool.apply(impl, *args)
    else:
        out = impl(*args)
    return out if len(lead) == 1 else out.reshape(*lead, m, c)
