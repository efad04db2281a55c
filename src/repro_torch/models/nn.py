"""Dense layer, LayerNorm and the per-point MLP stack as nn.Modules.

Every dense layer takes the numeric decision as an explicit
`ExecutionPolicy` — the paper's C4 (SC W16A16) with no hidden state:

    y = layer(x, policy=ExecutionPolicy(quant="sc_w16a16"))

`policy=None` (or quant="none") is the float path, a plain `torch.matmul`
as the reference leaves it to XLA.  The quantized path goes through
`kernels/sc_matmul` under the policy's backend.  Inside a shard of a
replica group (`sharding.hints.replica_axis_active()`), `policy.sharding`
routes a layer to the split-concatenate column split ("tensor") or makes
the activation scale global over the batch shards ("batch").

Weights keep the JAX package's layout, w (d_in, d_out) with y = x @ w, so
the SC kernel reads them as they are and `params.from_jax_params` copies
them without a transpose.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quant import quantize_symmetric
from repro_torch.kernels.sc_matmul.ops import sc_matmul_op, sc_quantized_linear
from repro_torch.sharding import hints
from repro_torch.sharding.hints import REPLICA_AXIS, replica_axis_active


def _shard_mode(policy: ExecutionPolicy | None) -> str | None:
    """The policy's sharding mode, but ONLY inside a shard of a replica group.

    Outside one the replica axis is unbound and every sharded code path is
    off, so a sharded policy runs exactly its unsharded twin's math there.
    """
    mode = getattr(policy, "sharding", None) if policy is not None else None
    if mode is None:
        return None
    return mode if replica_axis_active() else None


def draw_normal(*shape: int, generator: torch.Generator | None = None,
                device=None) -> torch.Tensor:
    """Standard normal float32 draws of `shape`, for a parameter bound for `device`.

    Drawn on the generator's device (the CPU without one), and the caller
    moves them to `device`: a CPU generator gives the same weights on every
    device, a CUDA one draws a large model in place.  For the meta device
    nothing is drawn: a meta tensor of the shape comes back, so that a model
    of any size builds on meta at once (`launch.shapes.abstract_params`).
    """
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    draw_on = None if generator is None else generator.device
    return torch.randn(*shape, generator=generator, device=draw_on)


class Linear(nn.Module):
    """Dense layer y = x @ w + b with w (d_in, d_out), float or SC-quantized.

    Initialised like the reference: w ~ N(0, 1/d_in), b = 0, in `dtype`
    (float32 by default), drawn as `draw_normal` says.
    """

    def __init__(
        self, d_in: int, d_out: int, *, bias: bool = True,
        generator: torch.Generator | None = None, device=None, dtype=None,
    ):
        super().__init__()
        dtype = dtype or torch.float32
        w = draw_normal(d_in, d_out, generator=generator, device=device) * (1.0 / math.sqrt(d_in))
        self.w = nn.Parameter(w.to(device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype)) if bias else None

    def forward(self, x: torch.Tensor, policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """Float matmul, or the SC integer path when the policy quantizes.

        Inside a shard of a replica group a "tensor" policy runs the column
        split (`_tensor_sharded`) and a "batch" one takes the activation
        scale's max over the group.
        """
        mode = _shard_mode(policy)
        if mode == "tensor":
            return self._tensor_sharded(x, policy)
        bits = None if policy is None else policy.quant_bits
        if bits is None:
            y = torch.matmul(x, self.w)
        else:
            y = sc_quantized_linear(
                x, self.w, bits=bits, backend=policy.resolved_backend(),
                amax_axis=REPLICA_AXIS if mode == "batch" else None,
            ).to(x.dtype)
        if self.b is not None:
            y = y + self.b
        return y

    def _tensor_sharded(self, x: torch.Tensor, policy: ExecutionPolicy) -> torch.Tensor:
        """Column-split linear across the replica group (split-concatenate).

        Each shard multiplies against its block of the weight's columns and
        the blocks are gathered along the last dim: the paper's SC dataflow
        lifted to a device group.  Bitwise equal to the replicated linear:
        float columns are independent, and the quantized path quantizes the
        FULL weight first (one global per-tensor scale) and slices its
        integer columns, whose product is exact.  N is zero-padded up to a
        multiple of the group size; the pad columns are dropped after the
        gather, and the bias is added last.
        """
        w = self.w
        k, n = w.shape
        group, idx = hints.axis_size(), hints.axis_index()
        cols = -(-n // group)  # ceil: the last shard may hold zero-pad columns
        pad = cols * group - n
        bits = policy.quant_bits
        if bits is None:
            wl = torch.nn.functional.pad(w, (0, pad))[:, idx * cols:(idx + 1) * cols]
            y = torch.matmul(x, wl)
        else:
            lead = x.shape[:-1]
            xq = quantize_symmetric(x.reshape(-1, k), bits)
            wq = quantize_symmetric(w, bits)  # the full weight: one global scale
            wl = torch.nn.functional.pad(wq.q, (0, pad))[:, idx * cols:(idx + 1) * cols]
            y = sc_matmul_op(xq.q, wl, bits=bits, backend=policy.resolved_backend())
            y = (y * (xq.scale * wq.scale)).reshape(*lead, cols).to(x.dtype)
        y = hints.all_gather(y, dim=-1)[..., :n]
        if self.b is not None:
            y = y + self.b
        return y


class LayerNorm(nn.Module):
    """LayerNorm with statistics in float32: (x - mu) * rsqrt(var + eps) * g + b.

    Written out as the reference writes it, rather than F.layer_norm, so both
    packages evaluate the same formula.
    """

    def __init__(self, d: int, *, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype or torch.float32))
        self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise over the last dim."""
        x32 = x.to(torch.float32)
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
        y = (x - mu.to(x.dtype)) * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * self.g + self.b


class MLPLayer(nn.Module):
    """One [linear -> LN] layer of an MLP stack (LN absent when norm=False)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool, norm: bool,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.lin = Linear(d_in, d_out, bias=bias, generator=generator, device=device)
        self.ln = LayerNorm(d_out, device=device) if norm else None

    def forward(self, x: torch.Tensor, policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """Linear, then LayerNorm if the layer has one."""
        x = self.lin(x, policy=policy)
        return self.ln(x) if self.ln is not None else x


class MLP(nn.Module):
    """Per-point MLP stack: [linear -> LN -> relu] per layer.

    LN stands in for the original BatchNorm (the reference's documented,
    statistics-free deviation).  `channels` = [d_in, hidden..., d_out].
    """

    def __init__(self, channels, *, bias: bool = True, norm: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            MLPLayer(cin, cout, bias=bias, norm=norm, generator=generator, device=device)
            for cin, cout in zip(channels[:-1], channels[1:])
        )

    def forward(self, x: torch.Tensor, *, final_act: bool = True,
                policy: ExecutionPolicy | None = None) -> torch.Tensor:
        """Apply every layer; relu after each, except the last when final_act=False."""
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x, policy=policy)
            if final_act or i < n - 1:
                x = torch.relu(x)
        return x


def count_params(params) -> int:
    """Number of scalar weights: of a module's parameters, or of every tensor or
    array in a dict/list/tuple tree (the reference's count over the tree's leaves)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel() if isinstance(params, torch.Tensor) else params.size)
