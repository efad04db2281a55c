"""Op-level FLOP and byte counter: the port's counterpart of the reference's
optimized-HLO analyzer, for the dry run's roofline terms.

The reference walks XLA's optimized HLO text.  The port has no HLO: it runs
eager torch, so `analyze(fn)` runs fn under a `TorchDispatchMode` that
records every aten op the call dispatches (on the card, the CPU or meta
tensors alike) and applies the reference's cost model to each:

  dot (mm, bmm, addmm, baddbmm, dot, mv) : 2 * prod(result dims) * K
  reduce (sum, mean, amax, max, var, cumsum, argmax, ...) : operand elements
  elementwise and everything else : result elements
  views, allocations, iota (arange), scalars : free
  bytes : operands + results, one read per operand and one write per
          result; a fill (zeros, full, fill_) writes its result alone; a gather (index, index_select, gather, embedding) moves
          2 * its result, as the reference charges `dynamic-slice`; a write
          into part of a tensor (index_put, index_copy, scatter) moves 2 *
          the update, as it charges `dynamic-update-slice`, and copy_
          (into a view, or whole) its source and its destination.

A hand-written kernel is one op with its own work, whichever version runs
(`core.accounting.kernel_call`): the SC matmul's 2 * M * K * N * planes^2
int8 plane-pair MACs and (M K + K N + M N) * 4 bytes, as `chip_smoke.py`'s
`bound()` counts them; the ops of its plain version are not counted.  So a
step counted on the card, on the CPU and on meta gives the same numbers.

The FLOPs are also split by the unit that runs them (`flops_by_type`),
since their peaks differ by up to 60x: a dot by its operands' dtype
("bfloat16", "float32", ...), the SC kernel's plane products as "sc_int8",
and every other FLOP (elementwise, reduce, gather, write) as "vector", one
operation an element.  `roofline_ms` takes one peak for each.

Known differences from the reference's counts:

  * eager torch has no fusion: every op's operands and results count as
    memory traffic, so the bytes are an upper bound on XLA's bytes at its
    fusion boundaries;
  * a Python loop dispatches its ops once an iteration, so no trip-count
    rollup is needed (`while_trip_counts` has no counterpart); on meta, a
    loop of identical iterations runs one under `core.accounting.repeat`;
  * op granularity differs (one `_softmax` where XLA has reduces and
    elementwise ops; no `convert` where a dtype does not change);
  * the counts are of the whole (global) program, where the reference's
    HLO is one device's, and `collectives` stays empty here: nothing is
    partitioned.  The dry run takes one device's collectives from its
    census pass (`launch.spmd`), which runs the step over DTensors, and
    writes them in this dict's `collectives` and `collective_bytes_total`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import accounting

aten = torch.ops.aten

# dot ops: position of the left operand, whose last dim is contracted
_DOTS = {
    aten.mm.default: 0, aten.bmm.default: 0, aten.addmm.default: 1,
    aten.baddbmm.default: 1, aten.dot.default: 0, aten.mv.default: 0,
}

_REDUCES = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean", "std",
    "std_mean", "logsumexp", "argmax", "argmin", "any", "all", "cumsum", "cumprod",
    "norm", "linalg_vector_norm", "nansum", "count_nonzero",
}

_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "arange",
    "scalar_tensor", "_local_scalar_dense", "lift_fresh", "lift_fresh_copy", "detach",
    "alias", "_unsafe_view", "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_has_compatible_shallow_copy_type", "sym_storage_offset",
}

_GATHERS = {"index", "index_select", "gather", "embedding"}

# fills write their result and read nothing (a broadcast constant in XLA)
_FILLS = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full"}

# write-into-part ops: name -> position of the update operand
_SCATTERS = {
    "index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "index_copy": 3,
    "index_copy_": 3, "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
    "index_add": 3, "index_add_": 3, "slice_scatter": 1, "select_scatter": 1,
}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def sc_matmul_cost(m: int, k: int, n: int, n_planes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one SC matmul (M, K) x (K, N) over n_planes 4-bit planes."""
    return 2 * m * k * n * n_planes * n_planes, (m * k + k * n + m * n) * 4


@dataclasses.dataclass
class Cost:
    """What a counted run did: ops, FLOPs, bytes, the FLOPs of its dots (SC
    kernels included), its FLOPs by type, and its collectives (none in the port)."""

    flops: int = 0
    bytes: int = 0
    ops: int = 0
    dot_flops: int = 0
    flops_by_type: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    collectives: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0.0, "bytes": 0.0}))
    by_kind: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    def as_dict(self) -> dict:
        """The reference's `analyze` keys (flops, bytes, collectives,
        collective_bytes_total), and ops, dot_flops, the FLOPs by type and the ops
        by kind."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "collective_bytes_total": sum(v["bytes"] for v in self.collectives.values()),
            "ops": self.ops,
            "dot_flops": self.dot_flops,
            "flops_by_type": dict(sorted(self.flops_by_type.items())),
            "ops_by_kind": dict(sorted(self.by_kind.items())),
        }


def op_cost(func, args, kwargs, out) -> tuple[str, int, int, int, str] | None:
    """(kind, FLOPs, bytes, dot FLOPs, FLOP type) of one aten op under the cost
    model; None for a free op."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE:
        return None
    ins = _tensors(args) + _tensors(list(kwargs.values()))
    outs = _tensors(out)
    out_elems = sum(t.numel() for t in outs)
    if func in _DOTS:
        lhs = args[_DOTS[func]]
        flops = 2 * out_elems * (lhs.shape[-1] if lhs.ndim else 1)
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return "dot", flops, nbytes, flops, str(lhs.dtype).removeprefix("torch.")
    if name in _GATHERS:
        return "gather", out_elems, 2 * sum(map(_nbytes, outs)), 0, "vector"
    if name in _FILLS:
        return "elementwise", out_elems, sum(map(_nbytes, outs)), 0, "vector"
    if name == "copy_":  # a write into (part of) its destination: read the source, write
        dst, src = args[0], args[1]
        return "write", dst.numel(), _nbytes(src) + _nbytes(dst), 0, "vector"
    if name in _SCATTERS:
        at = _SCATTERS[name]
        upd = _tensors(args[at] if len(args) > at else kwargs.get("src", kwargs.get("source")))
        return "write", sum(t.numel() for t in upd), 2 * sum(map(_nbytes, upd)), 0, "vector"
    nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    if name in _REDUCES:
        return "reduce", ins[0].numel() if ins else 0, nbytes, 0, "vector"
    return "elementwise", out_elems, nbytes, 0, "vector"


class _Counter(TorchDispatchMode):
    """The dispatch mode behind `counting`: every aten op, times the current scale."""

    def __init__(self):
        super().__init__()
        self.scale = Fraction(1)
        self.paused = 0
        self._lock = threading.Lock()
        self._scaled = {"flops": Fraction(0), "bytes": Fraction(0), "ops": Fraction(0),
                        "dot_flops": Fraction(0)}
        self._kinds: dict = defaultdict(Fraction)
        self._types: dict = defaultdict(Fraction)

    def _add(self, kind: str, flops: int, nbytes: int, dot: int, ftype: str) -> None:
        with self._lock:
            s = self.scale
            self._scaled["flops"] += flops * s
            self._scaled["bytes"] += nbytes * s
            self._scaled["ops"] += s
            self._scaled["dot_flops"] += dot * s
            self._kinds[kind] += s
            if flops:
                self._types[ftype] += flops * s

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            c = op_cost(func, args, kwargs, out)
            if c is not None:
                self._add(*c)
        return out

    def kernel_call(self, name: str, impl, args, kw):
        """Run one kernel call with its own ops unseen; count the kernel's work."""
        if name != "sc_matmul":
            raise ValueError(f"no cost model for kernel {name!r}")
        x_q, w_q = args
        flops, nbytes = sc_matmul_cost(x_q.shape[0], x_q.shape[1], w_q.shape[1],
                                       kw["n_planes"])
        with self._lock:
            self.paused += 1
        try:
            out = impl(*args, **kw)
        finally:
            with self._lock:
                self.paused -= 1
        self._add("sc_matmul", flops, nbytes, flops, "sc_int8")
        return out

    @contextlib.contextmanager
    def repeated(self, n):
        """Count every op inside n times more."""
        with self._lock:
            prev = self.scale
            self.scale = prev * Fraction(n)
        try:
            yield
        finally:
            with self._lock:
                self.scale = prev

    def result(self) -> Cost:
        """The counts so far (each an exact integer: a ragged loop's Fractions add up)."""
        cost = Cost()
        for key, v in self._scaled.items():
            if v.denominator != 1:
                raise ArithmeticError(f"{key} = {v} is not a whole number")
            setattr(cost, key, int(v))
        for kind, v in self._kinds.items():
            cost.by_kind[kind] = int(v)
        for ftype, v in self._types.items():
            if v.denominator != 1:
                raise ArithmeticError(f"{ftype} FLOPs = {v} is not a whole number")
            cost.flops_by_type[ftype] = int(v)
        return cost


_ACTIVE = threading.Lock()


@contextlib.contextmanager
def counting():
    """Count every op dispatched inside the block; yields a callable that gives the
    Cost so far.  One count at a time in a process (the hooks are process-wide)."""
    if not _ACTIVE.acquire(blocking=False):
        raise RuntimeError("an op count is already running in this process")
    counter = _Counter()
    try:
        accounting.set_counter(counter)
        with counter:
            yield counter.result
    finally:
        accounting.set_counter(None)
        _ACTIVE.release()


def analyze(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) under the counter; its Cost as a dict (`Cost.as_dict`)."""
    with counting() as cost:
        fn(*args, **kwargs)
    return cost().as_dict()


def roofline_ms(cost: dict, n_devices: int, peak_flops: dict,
                peak_bytes_per_s: float, link_bytes_per_s: float | None = None) -> dict:
    """The roofline terms of a counted run spread evenly over n_devices: compute ms
    (the sum over FLOP types of FLOPs / (n_devices * that type's peak)),
    memory ms (bytes / (n_devices * rate)) and, given a link rate, the
    reference's collective term: collective ms = collective_bytes_total /
    link_bytes_per_s (bytes that are already one device's).

    `bound_by` is decided by compute and memory alone.  The port's collective
    bytes are DTensor's greedy layout of the eager step (`launch.spmd`), not
    GSPMD's: 0.39-26.7x the reference's on a (2, 4) mesh
    (tests/test_torch_lm_collectives.py), so the collective term is an
    estimate of another partitioner, neither a lower nor an upper bound, and
    is reported beside the bound (`collective_estimate`) rather than in it.

    peak_flops maps every type in cost["flops_by_type"] to FLOP/s; a type
    without a peak raises KeyError.
    """
    by_type = {t: f / (n_devices * peak_flops[t]) * 1e3
               for t, f in cost["flops_by_type"].items()}
    compute = sum(by_type.values())
    memory = cost["bytes"] / (n_devices * peak_bytes_per_s) * 1e3
    terms = {"operations": compute, "bytes": memory}
    out = {"compute_ms": compute, "compute_ms_by_type": by_type, "memory_ms": memory}
    if link_bytes_per_s is not None:
        out["collective_ms"] = cost["collective_bytes_total"] / link_bytes_per_s * 1e3
        out["collective_estimate"] = "DTensor's greedy layout, not GSPMD's"
    out["bound_by"] = max(terms, key=lambda k: (terms[k], k == "operations"))
    return out
