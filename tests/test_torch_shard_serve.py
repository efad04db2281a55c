"""Port parity, sharded serving on the CPU: `ServingRuntime(...,
RuntimeConfig(max_batch=4, devices_per_replica=2), devices=["cpu"] * 4)`,
two replicas over the two pairs of `cpu` shards, serving sharded and
unsharded policies side by side.

  * each response is bitwise equal to the port's single-device `infer` of
    the padded batch it rode in (members and bucket of the trace's
    `batch.assembled`), the runtime's contract, which the sharded artifacts
    keep (tests/test_torch_shard_parity.py);
  * and within 1e-5 (float) and 1e-3 (SC) of the JAX package's unsharded
    `ServingRuntime` on the same clouds, the bounds tests/test_torch_serve.py
    states;
  * a sharded batch never carries the preprocess cache, as in the reference;
  * a chaos kill of a group replica rejoins warm onto the same group,
    building no new `MeshArtifacts`;
  * a failing shard fails its call at once (the barrier is aborted) and the
    pool retries the batch on the other replica, leaving no shard thread.

Every wait carries a timeout and every runtime stops in a `finally`.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro.serve import RuntimeConfig as JRuntimeConfig
from repro.serve import ServingRuntime as JServingRuntime
from repro_torch.configs import get_config
from repro_torch.core import accelerator as accel_mod
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models import pointnet2 as PN
from repro_torch.params import from_jax_params
from repro_torch.serve import (
    AutoscalerConfig,
    ChaosInjector,
    Fault,
    RuntimeConfig,
    ServingRuntime,
    TraceConfig,
    assemble_batch,
    trace_problems,
)
from repro_torch.serve.queue import Request
from repro_torch.sharding import hints

jax.config.update("jax_platform_name", "cpu")

WAIT_S = 60
MAX_BATCH = 4
FLOAT_ATOL = 1e-5
SC_LOGIT_ATOL = 1e-3
DEVICES = ["cpu"] * 4
DEVICE_CPU = torch.device("cpu")
BATCH_F = ExecutionPolicy(sharding="batch")
TENSOR_SC = ExecutionPolicy(quant="sc_w16a16", sharding="tensor")


@pytest.fixture(scope="module")
def cfg():
    return get_config("pointnet2-cls", smoke=True)


@pytest.fixture(scope="module")
def bridged(cfg):
    jp = JPN.init_params(jax.random.PRNGKey(0), j_cls_smoke())
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _clouds(k, seed, lo=100, hi=300):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(lo, hi)), 3)).astype(np.float32)
            for _ in range(k)]


def _runtime(cfg, params, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_s", 1.0)  # batches queued before start flush full
    kw.setdefault("buckets", (256,))
    kw.setdefault("devices_per_replica", 2)
    kw.setdefault("trace", TraceConfig())
    return ServingRuntime(cfg, params, RuntimeConfig(**kw), devices=DEVICES)


def _wait_for(pred, what):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _check_against_infer(cfg, params, rt, clouds, policies, outs):
    """Each response bitwise equal to the port's single-device infer (of its
    policy's quant) of the padded batch the trace says it rode in."""
    events = rt.tracer.events()
    order = {e.trace_id: k for k, e in enumerate(e for e in events if e.name == "request.submit")}
    seen = set()
    for e in events:
        if e.name != "batch.assembled":
            continue
        idx, bucket = [order[t] for t in e.args["members"]], e.args["bucket"]
        pols = {policies[i] for i in idx}
        assert len(pols) == 1, "a batch mixed policies"
        quant = ExecutionPolicy(quant=(policies[idx[0]] or ExecutionPolicy()).quant)
        reqs = [Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0], bucket=bucket,
                        policy=resolve_policy(cfg, quant), deadline_t=None, submit_t=0.0,
                        future=None) for i in idx]
        want = get_accelerator(cfg, quant, device="cpu").infer(
            params, assemble_batch(reqs, bucket, 3, MAX_BATCH)).numpy()
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(outs[i], want[j])
            seen.add(i)
    assert seen == set(range(len(clouds)))


def _jax_serve(jparams, clouds, quant):
    """The same clouds through the JAX runtime (one device, unsharded), queued before start."""
    rt = JServingRuntime(j_cls_smoke(), jparams,
                         JRuntimeConfig(max_batch=MAX_BATCH, max_wait_s=1.0, buckets=(256,)),
                         policy=JPolicy(quant=quant))
    try:
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        return [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        rt.stop()


def _shard_threads():
    return [t for t in threading.enumerate() if t.name.startswith("pc2im-shard-")]


def test_sharded_and_unsharded_policies_served_side_by_side(cfg, bridged):
    """Four full batches a policy (batch float, tensor SC, unsharded float),
    queued before start: every response is bitwise the single-device infer
    of its padded batch, and near the JAX runtime's."""
    jp, params = bridged
    per = 8
    clouds = _clouds(3 * per, seed=1)
    policies = [BATCH_F] * per + [TENSOR_SC] * per + [None] * per
    rt = _runtime(cfg, params)
    try:
        assert [r.devices for r in rt.pool.replicas] == [(DEVICE_CPU,) * 2] * 2
        rt.warmup((None, BATCH_F, TENSOR_SC))
        futs = [rt.submit(c, policy=p) for c, p in zip(clouds, policies)]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= len(clouds),
                  "records")
    finally:
        rt.stop()
    snap = rt.metrics.snapshot()
    assert snap.completed == len(clouds) and snap.failed == 0 and snap.retries == 0
    shardings = {b.policy_key[3] for b in rt.metrics.batch_records if b.n_real}
    assert shardings == {"batch", "tensor", None}
    assert trace_problems(rt.tracer.events()) == []
    _check_against_infer(cfg, params, rt, clouds, policies, outs)
    for quant, atol, sl in (("none", FLOAT_ATOL, slice(0, per)),
                            ("sc_w16a16", SC_LOGIT_ATOL, slice(per, 2 * per)),
                            ("none", FLOAT_ATOL, slice(2 * per, 3 * per))):
        want = _jax_serve(jp, clouds[sl], quant)
        for g, w in zip(outs[sl], want):
            assert g.shape == (cfg.n_classes,) and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def test_sharded_batches_never_carry_the_cache(cfg, bridged):
    """With the preprocess cache on, the scheduler hands the pool a sharded
    micro-batch without the cache and an unsharded one with it; the sharded
    clouds, served twice, make no lookup, skip nothing and fill no entry."""
    _, params = bridged
    clouds = _clouds(MAX_BATCH, seed=2)
    rt = _runtime(cfg, params, cache_max_bytes=1 << 24)
    seen = []
    dispatch = rt.scheduler.dispatch_fn

    def spy(mb):
        seen.append((mb.policy.sharding, mb.cache is not None))
        return dispatch(mb)

    rt.scheduler.dispatch_fn = spy
    try:
        rt.warmup((BATCH_F, TENSOR_SC))
        futs = [rt.submit(c, policy=p) for _ in range(2) for p in (BATCH_F, TENSOR_SC)
                for c in clouds]
        rt.start()
        for f in futs:
            f.result(timeout=WAIT_S)
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= len(futs),
                  "records")
        sharded_stats = rt.cache_stats()
        futs = [rt.submit(c) for c in clouds]
        for f in futs:
            f.result(timeout=WAIT_S)
    finally:
        rt.stop()
    assert sharded_stats.entries == 0
    assert not any(b.preprocess_skipped for b in rt.metrics.batch_records)
    assert sorted(set(seen), key=str) == sorted({("batch", False), ("tensor", False),
                                                 (None, True)}, key=str)
    snap = rt.metrics.snapshot()
    assert snap.cache_hits + snap.cache_misses == len(clouds)  # the unsharded batch only


def test_chaos_kill_and_warm_rejoin_onto_the_same_group(cfg, bridged, monkeypatch):
    """Replica 1 is killed at its first real sharded batch; the batch
    retries on replica 0, the autoscaler rejoins slot 1 onto the same pair
    of shards, and a second wave runs on both.  No MeshArtifacts is built
    after the warmup, and no request fails."""
    _, params = bridged
    built = []
    real_init = accel_mod.MeshArtifacts.__init__

    def counting_init(self, accel, devices):
        built.append(tuple(devices))
        real_init(self, accel, devices)

    monkeypatch.setattr(accel_mod.MeshArtifacts, "__init__", counting_init)
    accel_mod.clear_cache()  # so that the warmup builds the group's artifact
    wave1, wave2 = _clouds(8, seed=4), _clouds(8, seed=5)
    rt = _runtime(cfg, params, autoscaler=AutoscalerConfig(
        poll_interval_s=0.02, rejoin_delay_s=0.05, min_replicas=2))
    chaos = ChaosInjector([Fault(replica_id=1, at_batch=0, kind="kill")]).attach(rt.pool)
    group1 = rt.pool.replicas[1].devices
    try:
        rt.warmup((TENSOR_SC,))
        n_built = len(built)
        futs = [rt.submit(c, policy=TENSOR_SC) for c in wave1]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: rt.metrics.rejoins >= 1, "the rejoin")
        futs = [rt.submit(c, policy=TENSOR_SC) for c in wave2]
        outs += [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= 16, "records")
    finally:
        rt.stop()
    assert [(e.kind, e.replica_id) for e in chaos.fired()] == [("kill", 1)]
    assert ("rejoin", 1) in [(e.action, e.replica_id) for e in rt.autoscaler.events]
    assert rt.pool.replicas[1].devices == group1
    assert n_built == 1 and len(built) == n_built  # the rejoin built nothing new
    snap = rt.metrics.snapshot()
    assert snap.completed == 16 and snap.failed == 0 and snap.evictions == 1
    assert trace_problems(rt.tracer.events()) == []
    _check_against_infer(cfg, params, rt, wave1 + wave2, [TENSOR_SC] * 16, outs)


def test_a_failing_shard_fails_over_within_a_timeout(cfg, bridged, monkeypatch):
    """Shard 1 of the first sharded call raises inside the feature stage:
    the call's other shard stops at the barrier at once, the batch retries
    on the other replica and answers bitwise, well inside the collective
    timeout, with no shard thread left waiting."""
    _, params = bridged
    real = PN.feature_stage
    fired = []

    def flaky(*args, **kw):
        if hints.replica_axis_active() and hints.axis_index() == 1 and not fired:
            fired.append(threading.current_thread().name)
            raise RuntimeError("injected shard failure")
        return real(*args, **kw)

    clouds = _clouds(MAX_BATCH, seed=6)
    rt = _runtime(cfg, params)
    try:
        rt.warmup((TENSOR_SC,))
        monkeypatch.setattr(PN, "feature_stage", flaky)
        t0 = time.monotonic()
        futs = [rt.submit(c, policy=TENSOR_SC) for c in clouds]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        elapsed = time.monotonic() - t0
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= len(clouds),
                  "records")
    finally:
        rt.stop()
    assert fired and fired[0].startswith("pc2im-shard-1")
    assert elapsed < 30
    snap = rt.metrics.snapshot()
    assert snap.retries == 1 and snap.failed == 0 and snap.completed == len(clouds)
    _check_against_infer(cfg, params, rt, clouds, [TENSOR_SC] * len(clouds), outs)
    _wait_for(lambda: not _shard_threads(), "the shard threads to end")


@pytest.mark.parametrize("policy", [BATCH_F, TENSOR_SC], ids=["batch", "tensor-sc"])
def test_two_replicas_share_one_artifact_under_concurrent_traffic(cfg, bridged, policy):
    """Both replicas' groups name the same devices, so they share one
    MeshArtifacts; 24 clouds arriving over time keep both busy at once, and
    every response is still bitwise its batch's single-device infer."""
    _, params = bridged
    clouds = _clouds(24, seed=7)
    rt = _runtime(cfg, params, max_wait_s=0.002)
    try:
        rt.warmup((policy,))
        accel = get_accelerator(cfg, policy, device="cpu")
        groups = [r.devices for r in rt.pool.replicas]
        assert groups[0] == groups[1]
        assert accel.mesh_artifacts(groups[0]) is accel.mesh_artifacts(groups[1])
        rt.start()
        futs = []
        for c in clouds:
            futs.append(rt.submit(c, policy=policy))
            time.sleep(0.002)
        outs = [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= len(clouds),
                  "records")
    finally:
        rt.stop()
    real = [b for b in rt.metrics.batch_records if b.n_real]
    assert {b.replica_id for b in real} == {0, 1}
    assert rt.metrics.snapshot().failed == 0
    _check_against_infer(cfg, params, rt, clouds, [policy] * len(clouds), outs)
