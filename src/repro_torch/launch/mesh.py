"""Device groups for serving replicas, and the collectives of one group.

`carve_device_groups` cuts a device list into the serving pool's units of
capacity, and `make_replica_mesh` makes the 1-D mesh that one replica's
group forms.  The JAX package maps one computation over such a mesh with
`shard_map` (single-controller SPMD); the port runs one worker thread a
shard instead (`ReplicaMesh.run`): each thread is bound to its device and
to CUDA streams of its own, runs the same body on its rows, and reaches
the other shards only through one call's `ReplicaGroup` and its two
collectives, `all_max` and `all_gather`.  They are built from a
`threading.Barrier` and a slot a shard:

  * a shard writes its tensor into its slot and records a CUDA event on
    its stream after the write;
  * after the barrier, each reader makes its stream wait on that event,
    marks the source as used by the stream that reads or copies it
    (`Tensor.record_stream`, so that the caching allocator does not reuse
    its memory early) and copies it to its own device: a peer copy over
    NVLink across cards, no copy at all between two shards on one card,
    and plain tensors on the CPU;
  * slots come in two sets used in turn, so a slot is written again only
    after every shard has passed the next barrier, and so has read it.

A group may name one device more than once: that puts several shards on
one card, or on the CPU, each with a stream (or a thread) of its own.
It is how the port's tests run groups of `("cpu",) * g` and how one card
runs a group's shards side by side, the counterpart of the forced host
devices (`xla_force_host_platform_device_count`) the reference's tests
use.  A one-device group is valid and runs the unsharded math.

The LM's meshes are of another kind: `Mesh` names axes and their sizes
for the sharding rules (`sharding.policy`) and the activation hints
(`sharding.hints`).  `make_production_mesh` describes the reference's
deployments, 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data",
"model"), with no devices behind them: the dry run (`launch/dryrun.py`)
lays a model out on them and counts its work, and nothing runs there.
`make_host_mesh` is the 1 x 1 mesh on the local card, where the layout is
applied (`sharding.spec.place`) and a step runs under the hints.  Mapping
the 16-wide model axis onto 8-GPU NVLink nodes, and running one program
over several cards, are not part of the port (ROADMAP.md queue B).
"""

from __future__ import annotations

import threading
import time

import torch

from repro_torch.core.device import on_streams, resolve_device
from repro_torch.sharding.hints import replica_axis

# Bound on every wait of a sharded call: a barrier, and the caller's join of
# the shard threads.  A shard that fails aborts the barrier at once; this
# bounds only a shard that hangs.
COLLECTIVE_TIMEOUT_S = 120.0


def carve_device_groups(devices, per_replica: int) -> list[tuple]:
    """Partition a device list into consecutive groups of `per_replica`.

    The serving pool's unit of capacity: each group backs one replica
    (per_replica=1 is one device a replica).  Leftover devices that do not
    fill a whole group are unused, as in the reference.  Raises ValueError
    when per_replica < 1 or exceeds the device count.
    """
    devices = list(devices)
    if per_replica < 1:
        raise ValueError(f"devices_per_replica must be >= 1, got {per_replica}")
    if per_replica > len(devices):
        raise ValueError(
            f"devices_per_replica={per_replica} exceeds the "
            f"{len(devices)} available device(s)"
        )
    n = len(devices) // per_replica
    return [tuple(devices[i * per_replica : (i + 1) * per_replica]) for i in range(n)]


def take(x: torch.Tensor, ready, device: torch.device) -> torch.Tensor:
    """Another thread's tensor `x` as a tensor on `device`, read on this thread's streams.

    `ready` is the CUDA event recorded after `x` was written (None on the
    CPU).  This thread's stream on `device` waits for it; a copy from
    another card runs on this thread's stream on x's card, which PyTorch
    orders after that wait and before the destination stream's next work.
    """
    if ready is not None:
        torch.cuda.current_stream(device).wait_event(ready)
        x.record_stream(torch.cuda.current_stream(x.device))
    return x.to(device)


def ready_event(x: torch.Tensor):
    """A CUDA event recorded on this thread's stream of x's card (None on the CPU)."""
    if not x.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return ev


class ReplicaGroup:
    """One sharded call's collectives: a barrier and two sets of slots a shard.

    Made anew for every call (`ReplicaMesh.run`), so concurrent calls over
    one mesh never share a barrier or a slot.  `abort()` breaks the
    barrier: every shard waiting there, or arriving later, raises
    `threading.BrokenBarrierError` instead of waiting.
    """

    def __init__(self, mesh: "ReplicaMesh", timeout_s: float):
        self.mesh = mesh
        self.size = mesh.size
        self._barrier = threading.Barrier(self.size, timeout=timeout_s)
        self._slots = ([None] * self.size, [None] * self.size)
        self._rounds = [0] * self.size
        self._lock = threading.Lock()
        self._errors: list[tuple[int, BaseException]] = []

    def _exchange(self, index: int, x: torch.Tensor) -> list[torch.Tensor]:
        """Every shard's `x`, in shard order, on shard `index`'s device."""
        slots = self._slots[self._rounds[index] % 2]
        self._rounds[index] += 1
        slots[index] = (x, ready_event(x))
        self._barrier.wait()
        device = self.mesh.devices[index]
        return [take(t, ready, device) for t, ready in slots]

    def all_max(self, index: int, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of `x` over the group, on shard `index`'s device."""
        return torch.stack(self._exchange(index, x)).amax(dim=0)

    def all_gather(self, index: int, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's `x` concatenated along `dim` in shard order."""
        return torch.cat(self._exchange(index, x), dim=dim)

    def fail(self, index: int, error: BaseException) -> None:
        """Record shard `index`'s error and abort the barrier."""
        with self._lock:
            self._errors.append((index, error))
        self._barrier.abort()

    def abort(self) -> None:
        """Break the barrier, so that no shard waits on it any more."""
        self._barrier.abort()

    def first_error(self) -> BaseException | None:
        """The error that broke the call: the first shard's that was not a broken barrier.

        A shard that fails aborts the barrier, so the other shards' errors
        are its consequence.  Where every shard saw a broken barrier, a
        barrier wait timed out, and the call raises TimeoutError.
        """
        with self._lock:
            errors = list(self._errors)
        if not errors:
            return None
        for _, e in errors:
            if not isinstance(e, threading.BrokenBarrierError):
                return e
        index, e = errors[0]
        err = TimeoutError(f"a collective of the replica group timed out (shard {index})")
        err.__cause__ = e
        return err


class ReplicaMesh:
    """The 1-D mesh of one replica's device group: its devices and its shards' streams.

    `devices[i]` runs shard i.  On the card each shard owns one CUDA stream
    on every distinct device of the group, made at the first call: the one
    on its own device runs its work, the others run the peer copies it
    reads (a copy runs on the source card's current stream).
    """

    def __init__(self, devices):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("replica mesh needs at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"a replica group must be all CUDA devices or all the CPU, "
                             f"got {self.devices}")
        self.size = len(self.devices)
        self._streams: list[list] | None = None
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return f"ReplicaMesh({[str(d) for d in self.devices]})"

    def _shard_streams(self, index: int) -> list:
        """Shard `index`'s streams, its own device's last (empty on the CPU)."""
        if self.devices[0].type != "cuda":
            return []
        with self._lock:
            if self._streams is None:
                distinct = list(dict.fromkeys(self.devices))
                self._streams = [
                    [torch.cuda.Stream(d) for d in distinct if d != own]
                    + [torch.cuda.Stream(own)]
                    for own in self.devices
                ]
            return self._streams[index]

    def run(self, body, *, timeout_s: float = COLLECTIVE_TIMEOUT_S) -> list:
        """Run body(index) once a shard, each on its device and streams; return the results.

        Shard 0 runs on the calling thread and every other shard on a
        thread of its own, each with REPLICA_AXIS bound to this call's
        group and under `torch.inference_mode()`.  On the card each result
        comes back as (tensor, event): the event is recorded on the shard's
        stream of the tensor's card after the body, and a reader's stream
        waits on it (`gather_rows`).  If a shard raises, the barrier is
        aborted so no shard waits on it, and the first shard's error is
        raised here once every thread has ended; a thread still running
        after `timeout_s` raises TimeoutError.
        """
        group = ReplicaGroup(self, timeout_s)
        results: list = [None] * self.size

        def shard(index: int) -> None:
            try:
                with on_streams(*self._shard_streams(index)), \
                        replica_axis(group, index), torch.inference_mode():
                    out = body(index)
                    results[index] = (out, ready_event(out))
            except Exception as e:  # noqa: BLE001 — relayed to the caller
                group.fail(index, e)
            except BaseException:
                group.abort()
                raise

        threads = [threading.Thread(target=shard, args=(i,), daemon=True,
                                    name=f"pc2im-shard-{i}")
                   for i in range(1, self.size)]
        for t in threads:
            t.start()
        shard(0)
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            group.abort()
            raise TimeoutError(f"a shard of {self!r} was still running after {timeout_s} s")
        error = group.first_error()
        if error is not None:
            raise error
        return results


def gather_rows(results: list, device: torch.device) -> torch.Tensor:
    """Concatenate `ReplicaMesh.run`'s results along dim 0 on `device`.

    Each result already lies on `device`; on the card the caller's current
    stream waits on each one's event first, so the result is ordered on
    that stream like any other work of the caller.
    """
    parts = [take(out, ready, device) for out, ready in results]
    return torch.cat(parts, dim=0)


def make_replica_mesh(devices) -> ReplicaMesh:
    """1-D serving mesh over ONE replica's device group (the axis is `hints.REPLICA_AXIS`).

    A one-device group is valid; the sharded artifacts then run the
    unsharded math on that device, so policy semantics do not depend on
    group size.
    """
    return ReplicaMesh(devices)


class Mesh:
    """Named mesh axes and their sizes, with the devices behind them or none.

    shape: ordered {axis name: size}; axis_names: the names in order;
    devices: a tuple of torch.devices, one a mesh position in row-major
    order, or None for an abstract mesh (a deployment described, not run).
    """

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...], devices=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if len(devices) != self.size:
                raise ValueError(f"{len(devices)} devices for a mesh of {self.size}")
        self.devices = devices

    @property
    def size(self) -> int:
        """Number of mesh positions (devices, for a concrete mesh)."""
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        where = "abstract" if self.devices is None else list(map(str, self.devices))
        return f"Mesh({self.shape}, {where})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's deployments as abstract meshes: 16 x 16 ("data", "model"),
    or 2 x 16 x 16 ("pod", "data", "model") with multi_pod.

    "pod" is data parallelism across pods, "data" FSDP and the batch,
    "model" tensor and expert parallelism.  No devices: the dry run lays a
    model out on it and counts its work.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(device=None) -> Mesh:
    """The 1 x 1 ("data", "model") mesh on the local card (the reference's host mesh).

    On the card unless `device` names another ("cpu" for the tests); raises
    without a card otherwise, as every entry point of the port does.
    """
    return Mesh((1, 1), ("data", "model"), devices=(resolve_device(device),))
