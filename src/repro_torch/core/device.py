"""Where the port's entry points run: the card, unless the caller names another device.

Kept apart from `core/accelerator.py` so that the model and the weight
bridge resolve devices the same way without importing the accelerator.
It also holds what ties streams, device-wide synchronisation and CUDA graph
captures together.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# One CUDA graph capture at a time in the process (core/graphs.py), with the
# eager warm-up before it, and no device-wide synchronisation while one is
# under way: a synchronisation from any thread waits on the capturing
# stream, which invalidates the capture.  Re-entrant, so that a warmup holds
# it across its forward and several captures.
CAPTURE_LOCK = threading.RLock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names another.

    Raises RuntimeError for a CUDA device on a host without one.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_streams(*streams) -> contextlib.ExitStack:
    """Make each given CUDA stream current on this thread; None entries (the CPU) are skipped.

    The kernel wrappers launch on `torch.cuda.current_stream`, which is per
    thread, so a worker thread enters its stream before it runs a stage.
    """
    stack = contextlib.ExitStack()
    for s in streams:
        if s is not None:
            stack.enter_context(torch.cuda.stream(s))
    return stack


def synchronize(device: torch.device) -> None:
    """`torch.cuda.synchronize(device)`, held off while a CUDA graph is captured."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)
