"""Kernel registry: per-kernel dispatch by tensor device, plus launch counters.

Every kernel of the port registers a pair under one name:

  * `cuda`  — the wrapper that launches the hand-written CUDA kernel;
  * `plain` — the plain PyTorch version of the same function.

`dispatch(name, tensor, backend)` picks by the device the data lies on: a
CUDA tensor gets the kernel, a CPU tensor the plain version.  The backends
"auto" and "pallas" (and None) mean exactly that; "xla" asks for the plain
version, and is refused for a CUDA tensor, since there is no second GPU path
and a kernel must never be bypassed silently.  Nothing falls back: a CUDA
tensor reaches the kernel or an exception.

Each CUDA wrapper calls `count_launch(name, stream)` right after its kernel
launched, and nowhere else, so a run can show that its main path went
through the kernels (`reset_launches()` before, `launches()` after).  A CUDA
graph capture launches nothing: a wrapper names the stream it enqueued on,
a launch onto a stream under capture goes into the dict that
`recording(stream)` yields, and every replay of the graph adds that dict
once (`add_launches`), so the counters count the kernels the card ran.  The
GPU needs none of the TPU's lane padding: the kernels take any tile size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch

BACKENDS = (None, "auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: its CUDA launch wrapper and its plain version."""

    name: str
    plain: Callable
    cuda: Callable


_REGISTRY: dict[str, KernelSpec] = {}
_launches: dict[str, int] = {}
_count_lock = threading.Lock()
_recordings: dict[int, dict[str, int]] = {}  # stream under capture -> launches enqueued there


def register(name: str, *, plain: Callable, cuda: Callable) -> KernelSpec:
    """Register (or replace) the (plain, cuda) pair of kernel `name`."""
    spec = KernelSpec(name=name, plain=plain, cuda=cuda)
    _REGISTRY[name] = spec
    with _count_lock:
        _launches.setdefault(name, 0)
    return spec


def get(name: str) -> KernelSpec:
    """The registered pair of kernel `name` (KeyError if unknown)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    """Names of every registered kernel, sorted."""
    return sorted(_REGISTRY)


def dispatch(name: str, tensor: torch.Tensor, backend: str | None = "auto") -> Callable:
    """The implementation of `name` for data lying where `tensor` lies.

    CUDA tensor -> the kernel's launch wrapper (backend "xla" raises);
    CPU tensor -> the plain version.  Any other device raises.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    spec = get(name)
    kind = tensor.device.type
    if kind == "cuda":
        if backend == "xla":
            raise ValueError(
                f"backend='xla' selects the plain version of {name}, which this "
                "port runs only on CPU tensors; CUDA tensors always take the "
                "kernel (use backend 'auto' or 'pallas', or move the data to the CPU)"
            )
        return spec.cuda
    if kind == "cpu":
        return spec.plain
    raise ValueError(f"no implementation of {name} for device {tensor.device}")


def count_launch(name: str, stream: int | None = None) -> None:
    """Add one launch of kernel `name` (called by its CUDA wrapper only).

    `stream` is the handle of the stream the kernel was enqueued on; a
    launch onto a stream under `recording` goes to that recording instead.
    """
    with _count_lock:
        counts = _launches if stream is None else _recordings.get(stream, _launches)
        counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def recording(stream: int):
    """Record the launches enqueued on `stream` into a fresh dict, which it yields.

    Used around a CUDA graph capture on that stream, which enqueues the
    kernels without running them; launches on other streams count as usual.
    """
    counts: dict[str, int] = {}
    with _count_lock:
        if stream in _recordings:
            raise RuntimeError(f"stream {stream:#x} is already being recorded")
        _recordings[stream] = counts
    try:
        yield counts
    finally:
        with _count_lock:
            del _recordings[stream]


def add_launches(counts: dict[str, int]) -> None:
    """Add `counts` ({kernel name: launches}) to the counters.

    Called once for each replay of a captured graph, with the launches its
    capture recorded.
    """
    with _count_lock:
        for name, n in counts.items():
            _launches[name] = _launches.get(name, 0) + n


def launches() -> dict[str, int]:
    """Snapshot of the launch counters: {kernel name: launches since reset}."""
    with _count_lock:
        return dict(_launches)


def reset_launches() -> None:
    """Set every launch counter to 0."""
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def require_cuda_tensor(x: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless `x` is a contiguous CUDA tensor of `dtype` with `ndim` dims.

    The kernels take raw pointers: everything they assume about a tensor is
    checked here, before a pointer leaves Python.
    """
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got device {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
