"""Port parity, multi-device building blocks on the CPU: device-group carving
and the sharding knob against the JAX package, the replica axis and the
group collectives of `launch/mesh.py` (groups of `cpu` shards, one thread a
shard), and the row locality that batch sharding rests on.

Everything here is exact: carving, specs and cache keys are pure Python,
and the collectives move tensors without arithmetic (a max is exact).
Every wait carries a timeout, and every test that starts shard threads
checks that none is left running.
"""

import threading
import time

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.launch.mesh import carve_device_groups as j_carve
from repro.sharding.policy import REPLICA_SHARDING_MODES as J_MODES
from repro_torch.configs import get_config
from repro_torch.core.accelerator import cache_stats, clear_cache, get_accelerator
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.launch.mesh import ReplicaMesh, carve_device_groups, make_replica_mesh
from repro_torch.serve.queue import Request
from repro_torch.serve.scheduler import MicroBatch, assemble_batch, scatter_results
from repro_torch.sharding import hints
from repro_torch.sharding.policy import REPLICA_SHARDING_MODES, replica_specs

JOIN_S = 30


def _shard_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name.startswith("pc2im-shard-")]


def _no_shard_threads_left():
    deadline = time.monotonic() + JOIN_S
    while _shard_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _shard_threads() == []


# -- device-group carving: the reference's six cases -------------------------

CARVE_CASES = {
    "exact_division": ([0, 1, 2, 3], 2),
    "per_one_is_one_device_a_replica": ([0, 1, 2], 1),
    "whole_fleet_is_one_group": ([0, 1, 2, 3], 4),
    "leftover_devices_unused": ([0, 1, 2, 3], 3),
    "group_larger_than_fleet_raises": ([0, 1], 3),
    "nonpositive_group_raises": ([0, 1], 0),
}


@pytest.mark.parametrize("case", sorted(CARVE_CASES))
def test_carve_device_groups_matches_the_reference(case):
    devices, per = CARVE_CASES[case]
    try:
        want = j_carve(devices, per)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            carve_device_groups(devices, per)
        assert str(got.value) == str(e)
        assert case.endswith("_raises")
        return
    assert carve_device_groups(devices, per) == want
    assert not case.endswith("_raises")


def test_carving_keeps_repeated_devices_as_shards():
    cpu = torch.device("cpu")
    assert carve_device_groups([cpu] * 4, 2) == [(cpu, cpu), (cpu, cpu)]


# -- the ExecutionPolicy.sharding knob ---------------------------------------


def test_invalid_sharding_mode_rejected():
    with pytest.raises(ValueError, match="sharding"):
        ExecutionPolicy(sharding="bogus")


def test_sharding_excludes_pipelined_schedule():
    with pytest.raises(ValueError, match="pipeline"):
        ExecutionPolicy(sharding="batch", pipeline="pipelined")


def test_replica_specs_contract():
    """Params replicated, points and logits split by rows over the replica
    axis, in both modes; an unknown mode raises ValueError."""
    assert REPLICA_SHARDING_MODES == J_MODES
    for mode in REPLICA_SHARDING_MODES:
        specs = replica_specs(mode)
        assert specs.params is None
        assert specs.points == hints.REPLICA_AXIS and specs.logits == hints.REPLICA_AXIS
    with pytest.raises(ValueError, match="sharding mode"):
        replica_specs("bogus")


def test_cache_key_isolation():
    """Unsharded, batch and tensor traffic resolve to three accelerators;
    a repeated lookup hits."""
    clear_cache()
    try:
        cfg = get_config("pointnet2-cls", smoke=True)
        get_accelerator(cfg, device="cpu")
        get_accelerator(cfg, ExecutionPolicy(sharding="batch"), device="cpu")
        get_accelerator(cfg, ExecutionPolicy(sharding="tensor"), device="cpu")
        stats = cache_stats()
        assert stats.size == 3
        assert {k[4] for k in stats.keys} == {None, "batch", "tensor"}
        get_accelerator(cfg, ExecutionPolicy(sharding="batch"), device="cpu")
        assert cache_stats().size == 3
    finally:
        clear_cache()


def test_mesh_artifacts_requires_a_sharded_policy():
    cfg = get_config("pointnet2-cls", smoke=True)
    accel = get_accelerator(cfg, device="cpu")
    with pytest.raises(ValueError, match="sharding"):
        accel.mesh_artifacts(("cpu",))


def test_mesh_artifacts_cached_per_device_tuple():
    cfg = get_config("pointnet2-cls", smoke=True)
    accel = get_accelerator(cfg, ExecutionPolicy(sharding="batch"), device="cpu")
    a = accel.mesh_artifacts(("cpu", "cpu"))
    assert accel.mesh_artifacts([torch.device("cpu")] * 2) is a
    assert accel.mesh_artifacts(("cpu",) * 4) is not a
    assert a.mesh.size == 2 and a.mesh.devices == (torch.device("cpu"),) * 2


def test_replica_mesh_rejects_an_empty_group():
    with pytest.raises(ValueError, match="at least one device"):
        make_replica_mesh(())


# -- the replica axis and the collectives ------------------------------------


def test_replica_axis_unbound_outside_a_shard():
    assert not hints.replica_axis_active()
    with pytest.raises(NameError):
        hints.axis_index()
    with pytest.raises(NameError):
        hints.all_max(torch.ones(()))


@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_collectives_over_cpu_shards(g):
    """Shard i holds rows of value i: all_gather concatenates them in shard
    order on every shard, all_max is the largest, and the axis is bound
    inside the body only."""
    mesh = ReplicaMesh(("cpu",) * g)

    def body(i):
        assert hints.replica_axis_active() and hints.axis_size() == g
        assert hints.axis_index() == i
        x = torch.full((2, 3), float(i))
        gathered = hints.all_gather(x, dim=0)
        gathered_cols = hints.all_gather(x, dim=-1)
        top = hints.all_max(x.amax() - 10 * (i % 2))
        again = hints.all_gather(x + 1, dim=0)  # a second round reuses the other slots
        return torch.cat([gathered.flatten(), gathered_cols.flatten(), top[None],
                          again.flatten()])

    results = mesh.run(body)
    want_rows = torch.cat([torch.full((2, 3), float(i)) for i in range(g)])
    want_cols = torch.cat([torch.full((2, 3), float(i)) for i in range(g)], dim=-1)
    top = max(i - 10 * (i % 2) for i in range(g))
    want = torch.cat([want_rows.flatten(), want_cols.flatten(), torch.tensor([float(top)]),
                      (want_rows + 1).flatten()])
    assert len(results) == g
    for out, ready in results:
        assert ready is None
        assert torch.equal(out, want)
    assert not hints.replica_axis_active()
    _no_shard_threads_left()


def test_a_failing_shard_aborts_the_barrier_and_raises_its_own_error():
    """Shard 2 raises before its first collective: the others, waiting at
    the barrier, stop at once (no timeout) and the caller gets shard 2's
    error, with no shard thread left."""
    mesh = ReplicaMesh(("cpu",) * 4)

    def body(i):
        if i == 2:
            raise RuntimeError("shard 2 failed")
        return hints.all_gather(torch.ones(1), dim=0)

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        mesh.run(body, timeout_s=60)
    assert time.monotonic() - t0 < 30
    _no_shard_threads_left()


def test_a_shard_that_never_arrives_times_out():
    """Shard 1 skips the collective: the others' barrier wait times out and
    the call raises TimeoutError within its bound."""
    mesh = ReplicaMesh(("cpu",) * 3)

    def body(i):
        if i == 1:
            return torch.zeros(1)
        return hints.all_max(torch.ones(()))

    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mesh.run(body, timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    _no_shard_threads_left()


def test_concurrent_calls_over_one_mesh_keep_their_own_barriers():
    """Eight threads call one mesh at once, each with its own values and
    several collectives: every call gets its own answer back (the barrier
    and slots belong to the call).  A short switch interval interleaves the
    threads as much as it can."""
    mesh = ReplicaMesh(("cpu",) * 3)
    out, errors = {}, []

    def call(k):
        def body(i):
            x = torch.full((1,), float(100 * k + i))
            for _ in range(5):
                x = hints.all_gather(x, dim=0)[i:i + 1] + hints.all_max(x)
            return x
        try:
            out[k] = torch.cat([o for o, _ in mesh.run(body, timeout_s=60)])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def want(k):
        x = [float(100 * k + i) for i in range(3)]
        for _ in range(5):
            m = max(x)
            x = [v + m for v in x]
        return torch.tensor(x)

    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        callers = [threading.Thread(target=call, args=(k,)) for k in range(8)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in callers)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    for k in range(8):
        assert torch.equal(out[k], want(k)), k
    _no_shard_threads_left()


# -- row locality: the reference's property, over seeded draws ---------------

WIDTH = 6  # 3 coords + 3 features; any fixed width works
N_CLASSES = 5


@pytest.mark.parametrize("seed", range(30))
def test_assemble_scatter_row_locality_under_any_split(seed):
    """For any split of the static batch dim into contiguous chunks (ragged
    tails included), assembling each chunk's requests alone reproduces that
    chunk of the full assembly bitwise, and scattering each chunk's logits
    alone reproduces the full scatter: a shard that sees only its row block
    computes exactly what the unsharded batch hands it.  The draws follow
    the reference's hypothesis strategy."""
    rng = np.random.default_rng(seed)
    bucket = int(rng.choice([32, 64]))
    n_req = int(rng.integers(1, 7))
    sizes = [int(n) for n in rng.integers(1, 2 * bucket + 1, size=n_req)]
    max_batch = n_req + int(rng.integers(0, 4))
    cuts = (sorted({int(c) for c in rng.integers(1, max_batch, size=int(rng.integers(0, 4)))})
            if max_batch > 1 else [])
    bounds = [0] + cuts + [max_batch]
    task = str(rng.choice(["cls", "seg"]))
    reqs = [
        Request(id=i, cloud=rng.standard_normal((n, WIDTH)).astype(np.float32), n_orig=n,
                bucket=bucket, policy=None, deadline_t=None, submit_t=0.0, future=None)
        for i, n in enumerate(sizes)
    ]
    full = assemble_batch(reqs, bucket, WIDTH, max_batch)
    for lo, hi in zip(bounds, bounds[1:]):
        chunk = assemble_batch(reqs[lo:hi], bucket, WIDTH, hi - lo)
        np.testing.assert_array_equal(chunk, full[lo:hi])
    shape = (max_batch, bucket, N_CLASSES) if task == "seg" else (max_batch, N_CLASSES)
    logits = rng.standard_normal(shape).astype(np.float32)
    whole = scatter_results(task, logits, MicroBatch(tuple(reqs), bucket, None, full))
    pieces = []
    for lo, hi in zip(bounds, bounds[1:]):
        sub = MicroBatch(tuple(reqs[lo:hi]), bucket, None, full[lo:hi])
        pieces.extend(scatter_results(task, logits[lo:hi], sub))
    assert len(whole) == len(pieces) == len(reqs)
    for a, b in zip(whole, pieces):
        np.testing.assert_array_equal(a, b)
