"""Public ops: SC integer matmul + the drop-in quantized linear layer.

`sc_quantized_linear` is the `ExecutionPolicy(quant="sc_w16a16")` path behind
every MLP layer: float in, float out, SC-CIM integer GEMM inside.
"""

from __future__ import annotations

import torch

from repro_torch.core import accounting
from repro_torch.core.quant import quantize_symmetric
from repro_torch.kernels import registry
from repro_torch.kernels.sc_matmul.kernel import sc_matmul_cuda
from repro_torch.kernels.sc_matmul.ref import sc_matmul_plain

registry.register("sc_matmul", plain=sc_matmul_plain, cuda=sc_matmul_cuda)


def _sc_matmul_meta(x_q: torch.Tensor, w_q: torch.Tensor, *, n_planes: int) -> torch.Tensor:
    """The SC matmul's output on meta tensors (shapes alone, as the dry run builds
    them): an empty (M, N) float32 tensor, no kernel and no plain version."""
    return torch.empty((x_q.shape[0], w_q.shape[1]), dtype=torch.float32, device="meta")


def sc_matmul_op(
    x_q: torch.Tensor, w_q: torch.Tensor, *, bits: int = 16, backend: str | None = "auto"
) -> torch.Tensor:
    """Exact integer matmul via SC planes.  (M,K) x (K,N) int32 -> (M,N) float32.

    The kernel on the card, its plain version on the CPU, the shape alone on
    meta; an op counter (`core.accounting`) sees one kernel call in each case.
    """
    if bits % 4 or not 4 <= bits <= 16:
        raise ValueError(f"bits={bits} must be 4, 8, 12 or 16")
    impl = _sc_matmul_meta if x_q.is_meta else registry.dispatch("sc_matmul", x_q, backend)
    return accounting.kernel_call("sc_matmul", impl, x_q.contiguous(), w_q.contiguous(),
                                  n_planes=bits // 4)


def sc_quantized_linear(
    x: torch.Tensor, w: torch.Tensor, *, bits: int = 16, backend: str | None = "auto",
    amax_axis: str | None = None,
) -> torch.Tensor:
    """W16A16 (or W8A8) linear: float (..., K) x (K, N) -> float32 (..., N).

    The activation scale is per tensor over every row of the flattened batch,
    and the two scales are multiplied before they scale the product, as in
    the reference.  amax_axis: the bound replica axis to globalize the
    ACTIVATION scale over (batch sharding); the weight is replicated, so its
    local amax already is the global one.
    """
    lead = x.shape[:-1]
    xq = quantize_symmetric(x.reshape(-1, x.shape[-1]), bits, axis_name=amax_axis)
    wq = quantize_symmetric(w, bits)
    y = sc_matmul_op(xq.q, wq.q, bits=bits, backend=backend)
    y = y * (xq.scale * wq.scale)
    return y.reshape(*lead, w.shape[-1]).to(torch.float32)
