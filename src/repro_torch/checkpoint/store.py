"""Fault-tolerant checkpointing in the JAX package's on-disk format.

The format is the reference's (`checkpoint/store.py`), byte for byte, so a
checkpoint written by either package loads in the other:

  * step_<%012d>/data.msgpack.zst holds one msgpack map {"version": 1,
    "step", "extra", "leaves"}, each leaf a record {dtype, shape, data}
    (numpy's dtype string, or "bfloat16" over the raw 16-bit words),
    compressed with zstd when `zstandard` is installed and zlib otherwise
    (either reader sniffs the container);
  * the leaves are in `jax.tree_util.tree_flatten`'s order of the tree
    (`params.tree_leaves`: a module's parameters under their reference
    names, dict keys sorted, NamedTuple fields in order, None no leaf);
  * ATOMIC: written into a tmp directory, fsynced, then renamed; a
    COMPLETE marker names a finished step, and restore takes the newest;
  * ASYNC: `save_checkpoint(..., blocking=False)` copies every leaf to host
    memory first, then writes on a background thread;
  * the manager keeps the last `keep` steps and saves every `every` steps.

One deviation: the reference's `shardings=` (a tree of NamedShardings for
an elastic restore) is `device=` here, the device every restored tensor is
placed on: the card unless the caller names another, as the reference's
`jnp.asarray` places a restored leaf on the default accelerator.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
import zlib
from typing import Any

import msgpack
import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.params import tree_leaves, tree_unflatten

try:  # optional fast path; bare environments fall back to stdlib zlib
    import zstandard
except ImportError:
    zstandard = None

FORMAT_VERSION = 1
_MARKER = "COMPLETE"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _compress(payload: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(payload)
    return zlib.compress(payload, 3)


def _decompress(blob: bytes) -> bytes:
    """Sniff the container magic so either writer's files restore anywhere."""
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _to_host(leaf) -> np.ndarray | torch.Tensor:
    """A leaf copied to host memory now: a numpy array, or a CPU bfloat16 tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(leaf, copy=True)


def _record(arr) -> dict:
    if isinstance(arr, torch.Tensor):  # bfloat16: numpy has no such dtype
        return {"dtype": "bfloat16", "shape": list(arr.shape),
                "data": arr.view(torch.int16).numpy().view(np.uint16).tobytes()}
    return {"dtype": arr.dtype.str, "shape": list(arr.shape), "data": arr.tobytes()}


def _from_record(rec: dict) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        words = np.frombuffer(rec["data"], np.uint16).reshape(rec["shape"]).copy()
        return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    arr = np.frombuffer(rec["data"], np.dtype(rec["dtype"])).reshape(rec["shape"])
    return torch.from_numpy(arr.copy())


def save_checkpoint(directory: str, step: int, tree: Any, *, blocking: bool = True,
                    extra: dict | None = None) -> threading.Thread | None:
    """Save `tree` at `step` under directory/step_<N>/ atomically.

    Every leaf is copied to host memory before this returns, so the caller
    may go on updating its tensors while a non-blocking save writes.
    """
    host_leaves = [_to_host(x) for x in tree_leaves(tree)]  # snapshot NOW

    def _write():
        payload = msgpack.packb(
            {"version": FORMAT_VERSION, "step": step, "extra": extra or {},
             "leaves": [_record(a) for a in host_leaves]},
            use_bin_type=True,
        )
        comp = _compress(payload)
        final = os.path.join(directory, f"step_{step:012d}")
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "data.msgpack.zst"), "wb") as f:
            f.write(comp)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _MARKER), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            return  # concurrent save of the same step
        os.rename(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _complete_steps(directory: str) -> list[int]:
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and ".tmp" not in n
        and os.path.exists(os.path.join(directory, n, _MARKER))
    )


def latest_step(directory: str) -> int | None:
    """The newest step with a COMPLETE marker under `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, tree_like: Any, *, step: int | None = None, device=None):
    """Restore into the structure of `tree_like`.  Returns (tree, step, extra).

    A module in `tree_like` comes back as a copy holding the restored
    parameters; every tensor lies on `device` (the card unless the caller
    names another, `core.device.resolve_device`).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:012d}", "data.msgpack.zst")
    with open(path, "rb") as f:
        obj = msgpack.unpackb(_decompress(f.read()), raw=False)
    if obj["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {obj['version']}, this reader knows {FORMAT_VERSION}")
    n_like = len(tree_leaves(tree_like))
    if len(obj["leaves"]) != n_like:
        raise ValueError(f"checkpoint has {len(obj['leaves'])} leaves, expected {n_like}")
    dev = resolve_device(device)
    leaves = [_from_record(r).to(dev) for r in obj["leaves"]]
    return tree_unflatten(tree_like, leaves), obj["step"], obj["extra"]


class CheckpointManager:
    """Keeps the last `keep` checkpoints; async saves; restart-aware."""

    def __init__(self, directory: str, *, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree: Any, *, force: bool = False, extra=None) -> bool:
        """Save asynchronously when `step` is a multiple of `every` (or `force`)."""
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        self._pending = save_checkpoint(self.directory, step, tree, blocking=False, extra=extra)
        self._gc()
        return True

    def wait(self):
        """Wait for the save under way, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_or_none(self, tree_like, *, device=None):
        """`load_checkpoint` of the newest complete step, or None when there is none."""
        step = latest_step(self.directory)
        if step is None:
            return None
        return load_checkpoint(self.directory, tree_like, step=step, device=device)

    def _gc(self):
        steps = _complete_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:012d}"), ignore_errors=True)
