"""Port parity, the serving path on the CPU: the shared numpy helpers and the
content key against the JAX package, `ServingRuntime` responses against a
direct `infer` of the same padded batch (bitwise) and against the JAX
package's `ServingRuntime` on the same clouds, the queue, cache and replica
behaviour, the control-plane options, and replicas over device groups
serving sharded policies.

Tolerances and why:
  * the numpy helpers and content keys are equal, byte for byte;
  * a response against the port's own `infer` of the same padded batch is
    bitwise (the runtime's contract);
  * against the JAX runtime: float logits at atol 1e-5 and SC logits at
    atol 1e-3, the bounds tests/test_torch_seg.py states (torch's CPU
    matmul and XLA sum in different orders, and under SC such a difference
    can move an activation across one quantizer boundary).

Every blocking wait carries its own timeout and every runtime stops in a
`finally` (or a `with`), so a hang fails one test instead of the suite.
"""

import concurrent.futures
import pathlib
import re
import sys
import time

import jax
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.configs.pointnet2_seg import smoke_config as j_seg_smoke
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro.serve import RuntimeConfig as JRuntimeConfig
from repro.serve import ServingRuntime as JServingRuntime
from repro.serve.adapt import AdaptiveConfig as JAdaptiveConfig
from repro.serve.autoscaler import AutoscalerConfig as JAutoscalerConfig
from repro.serve import hashing as j_hashing
from repro.serve import pointcloud as j_pointcloud
from repro_torch.configs import get_config
from repro_torch.core.accelerator import cache_stats, clear_cache, get_accelerator
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.params import from_jax_params
from repro_torch.serve import (
    EVENTS,
    AdaptiveConfig,
    AdaptiveController,
    AdmissionQueue,
    Autoscaler,
    AutoscalerConfig,
    DeadlineExceeded,
    MetricsServer,
    MicroBatch,
    NoReplicaAvailable,
    QueueFull,
    ReplicaPool,
    Reporter,
    RuntimeConfig,
    ServeMetrics,
    ServingRuntime,
    assemble_batch,
    bucket_for,
    content_key,
    inverse_subsample_indices,
    make_pointcloud_serve_fns,
    make_serving_runtime,
    pad_cloud,
    quantize_cloud,
    scatter_results,
    subsample_indices,
)
from repro_torch.serve.dispatch import pool_devices
from repro_torch.serve.queue import Request

jax.config.update("jax_platform_name", "cpu")

WAIT_S = 60
MAX_BATCH = 4
FLOAT_ATOL = 1e-5
SC_LOGIT_ATOL = 1e-3
SC = ExecutionPolicy(quant="sc_w16a16")
SERVE_SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "serve"


@pytest.fixture(scope="module")
def cfg():
    return get_config("pointnet2-cls", smoke=True)  # n_points=256


@pytest.fixture(scope="module")
def seg_cfg():
    return get_config("pointnet2-seg", smoke=True)  # n_points=256


@pytest.fixture(scope="module")
def bridged():
    """JAX params of each smoke config and the same weights in the port, on the CPU."""
    out = {}
    for name, jcfg, tcfg in (("cls", j_cls_smoke(), get_config("pointnet2-cls", smoke=True)),
                             ("seg", j_seg_smoke(), get_config("pointnet2-seg", smoke=True))):
        jp = JPN.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def params(bridged):
    return bridged["cls"][1]


def _clouds(k, sizes=(256,), seed=0, width=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((sizes[i % len(sizes)], width)).astype(np.float32)
            for i in range(k)]


def _runtime(cfg, params, *, policy=None, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_s", 0.005)
    kw.setdefault("max_queue", 64)
    kw.setdefault("buckets", (cfg.n_points,))
    return ServingRuntime(cfg, params, RuntimeConfig(**kw), policy=policy, device="cpu")


def _serve_once(rt, clouds, **submit_kw):
    """Queue every cloud before start (so they batch together), serve, stop."""
    try:
        futs = [rt.submit(c, **submit_kw) for c in clouds]
        rt.start()
        return [f.result(timeout=WAIT_S) for f in futs]
    finally:
        rt.stop()


def _records(metrics, n_requests):
    """The batch records once they hold n_requests real requests.

    A request's future is set before its batch is recorded, so the last
    record may land a moment after the last response.
    """
    deadline = time.monotonic() + WAIT_S
    while sum(b.n_real for b in metrics.batch_records) < n_requests:
        assert time.monotonic() < deadline, metrics.batch_records
        time.sleep(0.001)
    return metrics.batch_records


def _direct(cfg, params, clouds, policy=None, bucket=256):
    """The port's infer of the padded batch the scheduler assembles for `clouds`."""
    accel = get_accelerator(cfg, policy, device="cpu")
    reqs = [Request(id=i, cloud=c, n_orig=c.shape[0], bucket=bucket,
                    policy=resolve_policy(cfg, policy), deadline_t=None, submit_t=0.0,
                    future=None) for i, c in enumerate(clouds)]
    batch = assemble_batch(reqs, bucket, 3, MAX_BATCH)
    return accel.infer(params, batch).numpy(), reqs, batch


# -- shared numpy helpers against the JAX package -------------------------------


@pytest.mark.parametrize("n", [1, 100, 255, 256, 257, 300, 1000])
def test_pad_and_subsample_equal_the_jax_package(n):
    cloud = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    got, n_got = pad_cloud(cloud, 256)
    want, n_want = j_pointcloud.pad_cloud(cloud, 256)
    assert n_got == n_want == n
    np.testing.assert_array_equal(got, want)
    if n > 256:
        np.testing.assert_array_equal(subsample_indices(n, 256),
                                      j_pointcloud.subsample_indices(n, 256))
        np.testing.assert_array_equal(inverse_subsample_indices(n, 256),
                                      j_pointcloud.inverse_subsample_indices(n, 256))


@pytest.mark.parametrize("step", [1e-3, 0.05])
@pytest.mark.parametrize("kind", ["finite", "nonfinite", "wide", "features"])
def test_content_key_equals_the_jax_package(kind, step):
    rng = np.random.default_rng(3)
    cloud = rng.standard_normal((300, 6 if kind == "features" else 3)).astype(np.float32)
    if kind == "nonfinite":
        cloud[0, 0], cloud[1, 1], cloud[2, 2] = np.nan, np.inf, -np.inf
    if kind == "wide":
        cloud[5] = 1e7  # cells beyond int32: the key hashes int64 cells
    np.testing.assert_array_equal(quantize_cloud(cloud, step),
                                  j_hashing.quantize_cloud(cloud, step))
    assert content_key(cloud, step) == j_hashing.content_key(cloud, step)


def test_bucketing_routes_to_smallest_fit():
    assert bucket_for(100, (192, 256)) == 192
    assert bucket_for(192, (192, 256)) == 192
    assert bucket_for(193, (192, 256)) == 256
    assert bucket_for(999, (192, 256)) == 256  # oversized -> largest


def test_seg_scatter_maps_rows_back():
    small, big = np.zeros((100, 3), np.float32), np.zeros((300, 3), np.float32)
    reqs = [Request(id=i, cloud=c, n_orig=c.shape[0], bucket=256, policy=None,
                    deadline_t=None, submit_t=0.0, future=None) for i, c in enumerate((small, big))]
    mb = MicroBatch(requests=tuple(reqs), bucket=256, policy=None,
                    batch=np.zeros((4, 256, 3), np.float32))
    logits = np.arange(4 * 256, dtype=np.float32).reshape(4, 256)[..., None]
    outs = scatter_results("seg", logits, mb)
    np.testing.assert_array_equal(outs[0], logits[0, :100])
    np.testing.assert_array_equal(outs[1], logits[1, inverse_subsample_indices(300, 256)])


def test_serve_batch_equals_direct_infer(cfg, params):
    fns = make_pointcloud_serve_fns(cfg, device="cpu")
    clouds = _clouds(5, sizes=(256, 150, 300), seed=1)
    outs = fns["serve_batch"](params, clouds)
    assert len(outs) == 5 and fns["accelerator"].device == torch.device("cpu")
    batch = np.zeros((8, 256, 3), np.float32)
    for i, c in enumerate(clouds):
        batch[i] = pad_cloud(c, 256)[0]
    direct = fns["infer"](params, batch).numpy()
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, direct[i])


# -- the runtime against a direct infer -----------------------------------------


@pytest.mark.parametrize("pipeline", ["sequential", "pipelined"])
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_cls_responses_bitwise_equal_direct_infer(cfg, params, quant, pipeline):
    """Ragged clouds (padded and subsampled) in one micro-batch: each response is
    row i of infer on the padded batch, filler rows included in that batch."""
    policy = ExecutionPolicy(quant=quant, pipeline=pipeline)
    clouds = _clouds(3, sizes=(256, 150, 300), seed=2)
    outs = _serve_once(_runtime(cfg, params, policy=policy), clouds)
    direct, _, _ = _direct(cfg, params, clouds, policy)
    for i, out in enumerate(outs):
        assert out.shape == (cfg.n_classes,)
        np.testing.assert_array_equal(out, direct[i])


@pytest.mark.parametrize("pipeline", ["sequential", "pipelined"])
def test_seg_oversized_responses_bitwise_equal_direct_infer(seg_cfg, bridged, pipeline):
    """Seg: one row a point; padded clouds drop their filler rows, oversized ones
    map every input row to its nearest surviving row."""
    tp = bridged["seg"][1]
    policy = ExecutionPolicy(pipeline=pipeline)
    clouds = _clouds(3, sizes=(400, 100, 256), seed=3)
    outs = _serve_once(_runtime(seg_cfg, tp, policy=policy), clouds)
    direct, _, _ = _direct(seg_cfg, tp, clouds, policy)
    np.testing.assert_array_equal(outs[0], direct[0, inverse_subsample_indices(400, 256)])
    np.testing.assert_array_equal(outs[1], direct[1, :100])
    np.testing.assert_array_equal(outs[2], direct[2])
    assert [o.shape[0] for o in outs] == [400, 100, 256]


def test_mixed_policies_never_share_a_batch(cfg, params):
    clouds = _clouds(8, seed=4)
    rt = _runtime(cfg, params, max_wait_s=1.0)  # only full batches flush
    try:
        futs = [rt.submit(c, policy=SC if i % 2 else None) for i, c in enumerate(clouds)]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        rt.stop()
    records = [b for b in _records(rt.metrics, len(clouds)) if b.n_real]
    assert len(records) == 2 and {r.policy_key[0] for r in records} == {"none", "sc_w16a16"}
    for pol, idxs in ((None, (0, 2, 4, 6)), (SC, (1, 3, 5, 7))):
        direct, _, _ = _direct(cfg, params, [clouds[i] for i in idxs], pol)
        for j, i in enumerate(idxs):
            np.testing.assert_array_equal(outs[i], direct[j])


# -- the runtime against the JAX package's runtime -------------------------------


def _jax_serve(jcfg, jparams, clouds, quant):
    rt = JServingRuntime(jcfg, jparams, JRuntimeConfig(max_batch=MAX_BATCH, max_wait_s=0.005,
                                                        buckets=(256,)),
                         policy=JPolicy(quant=quant))
    try:
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        return [f.result(timeout=120) for f in futs]
    finally:
        rt.stop()


@pytest.mark.parametrize("model,quant,atol", [
    ("cls", "none", FLOAT_ATOL), ("cls", "sc_w16a16", SC_LOGIT_ATOL), ("seg", "none", FLOAT_ATOL),
])
def test_responses_match_the_jax_runtime(bridged, model, quant, atol):
    """The same clouds through both packages' runtimes, one JAX runtime per policy."""
    jp, tp = bridged[model]
    jcfg = j_cls_smoke() if model == "cls" else j_seg_smoke()
    tcfg = get_config(f"pointnet2-{model}", smoke=True)
    clouds = _clouds(3, sizes=(256, 150, 300), seed=5)
    want = _jax_serve(jcfg, jp, clouds, quant)
    got = _serve_once(_runtime(tcfg, tp, policy=ExecutionPolicy(quant=quant)), clouds)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


# -- queue, deadlines, one accelerator per key ----------------------------------


def test_queue_backpressure_rejects_with_reason():
    q = AdmissionQueue(max_depth=2)
    pol = ExecutionPolicy()
    cloud = np.zeros((8, 3), np.float32)
    q.submit(cloud, bucket=256, policy=pol)
    q.submit(cloud, bucket=256, policy=pol)
    with pytest.raises(QueueFull) as exc:
        q.submit(cloud, bucket=256, policy=pol)
    assert exc.value.reason == "queue_full" and exc.value.depth == 2
    assert q.depth() == 2


def test_runtime_backpressure_counts_rejections(cfg, params):
    rt = _runtime(cfg, params, max_queue=2)  # never started: the queue fills
    try:
        rt.submit(_clouds(1)[0])
        rt.submit(_clouds(1)[0])
        with pytest.raises(QueueFull):
            rt.submit(_clouds(1)[0])
        assert rt.metrics.rejected == 1 and rt.metrics.submitted == 2
    finally:
        rt.stop(drain=False)


def test_expired_request_fails_its_future(cfg, params):
    rt = _runtime(cfg, params)
    try:
        dead = rt.submit(_clouds(1)[0], timeout_s=0.0)  # past before the first drain
        live = rt.submit(_clouds(1, seed=1)[0])
        rt.start()
        assert live.result(timeout=WAIT_S).shape == (cfg.n_classes,)
        with pytest.raises(DeadlineExceeded):
            dead.result(timeout=WAIT_S)
    finally:
        rt.stop()
    assert rt.metrics.expired == 1 and rt.metrics.completed == 1


def test_deadline_expiring_in_pending_is_shed(cfg, params):
    rt = _runtime(cfg, params, max_wait_s=0.4)
    try:
        rt.start()
        fut = rt.submit(_clouds(1)[0], timeout_s=0.05)  # << max_wait_s
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=WAIT_S)
    finally:
        rt.stop()
    assert rt.metrics.expired == 1 and rt.metrics.completed == 0


def test_concurrent_submitters_build_one_accelerator_per_key(cfg, params):
    """16 submitter threads x 2 policies, switching threads every microsecond:
    exactly one accelerator per (config, policy, device) in the cache, and
    every request answered once."""
    clear_cache()
    rt = _runtime(cfg, params, max_queue=128)
    clouds = _clouds(32, seed=6)
    interval = sys.getswitchinterval()
    try:
        rt.start()
        sys.setswitchinterval(1e-6)
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
                futs = list(ex.map(lambda i: rt.submit(clouds[i], policy=SC if i % 2 else None),
                                   range(32)))
        finally:
            sys.setswitchinterval(interval)
        outs = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        rt.stop()
    assert rt.metrics.completed == 32 and rt.metrics.submitted == 32
    assert all(o.shape == (cfg.n_classes,) for o in outs)
    stats = cache_stats()
    assert stats.size == 2 and stats.misses == 2, stats
    assert {k[-1] for k in stats.keys} == {"cpu"}


def test_lifecycle_stop_without_start_and_no_restart(cfg, params):
    rt = _runtime(cfg, params)
    fut = rt.submit(_clouds(1)[0])
    rt.stop()  # never started: nothing could ever complete this
    assert fut.cancelled()
    with pytest.raises(Exception, match="closed"):
        rt.submit(_clouds(1)[0])
    with pytest.raises(RuntimeError, match="restarted"):
        rt.start()


def test_submit_validates_the_cloud(cfg, params):
    rt = _runtime(cfg, params)
    try:
        with pytest.raises(ValueError, match="n >= 1"):
            rt.submit(np.zeros((0, 3), np.float32))
        with pytest.raises(ValueError):
            rt.submit(np.zeros((4, 5), np.float32))
    finally:
        rt.stop(drain=False)


def test_warmup_batches_are_recorded_but_not_counted_as_traffic(cfg, params):
    rt = _runtime(cfg, params)
    try:
        rt.warmup((None, ExecutionPolicy(pipeline="pipelined")))
        outs = _serve_once(rt, _clouds(MAX_BATCH, seed=7))
    finally:
        rt.stop()
    assert len(outs) == MAX_BATCH
    warm = [b for b in _records(rt.metrics, MAX_BATCH) if not b.n_real]
    assert sorted(b.policy_key[2] for b in warm) == ["pipelined", "sequential"]
    snap = rt.metrics.snapshot()
    assert snap.batches == 1 and snap.mean_occupancy == 1.0


def test_make_serving_runtime_seeds_params_on_the_cpu(cfg):
    rt = make_serving_runtime(cfg, None, RuntimeConfig(max_batch=2), seed=3, device="cpu")
    try:
        out = _serve_once(rt, _clouds(1, seed=8))[0]
    finally:
        rt.stop()
    assert out.shape == (cfg.n_classes,) and np.isfinite(out).all()
    assert "cpu" in repr(rt)


# -- preprocess cache ------------------------------------------------------------


def _serial(rt, clouds, **kw):
    """One request at a time (one real row + filler per batch)."""
    return [rt.infer(c, **kw) for c in clouds]


def _wait_insertions(rt, n):
    """Block until the cache holds n insertions (all-miss fills are async)."""
    deadline = time.monotonic() + WAIT_S
    while rt.cache.stats().insertions < n:
        assert time.monotonic() < deadline, rt.cache.stats()
        time.sleep(0.005)


@pytest.mark.parametrize("pipeline", ["sequential", "pipelined"])
def test_cache_hits_bitwise_equal_uncached(cfg, params, pipeline):
    policy = ExecutionPolicy(pipeline=pipeline)
    clouds = _clouds(4, seed=20)
    with _runtime(cfg, params, policy=policy) as rt:
        ref = _serial(rt, clouds)
        assert rt.cache is None and rt.cache_stats() is None
    with _runtime(cfg, params, policy=policy, cache_max_bytes=2**24) as rt:
        first = _serial(rt, clouds)
        _wait_insertions(rt, len(clouds))
        second = _serial(rt, clouds)
        stats = rt.cache_stats()
        snap = rt.metrics.snapshot()
    for r, a, b in zip(ref, first, second):
        np.testing.assert_array_equal(r, a)
        np.testing.assert_array_equal(r, b)
    assert stats.hits >= 4 and stats.entries == 4
    assert snap.preprocess_skipped >= 1


def test_all_hit_sc_batch_equals_the_first_round(cfg, params):
    """Under SC the activation scale spans the whole batch, so both rounds are
    full batches (no filler rows): round two is all hits, bitwise equal."""
    clouds = _clouds(2 * MAX_BATCH, seed=21)
    # only full batches flush, however slowly the second round is submitted
    rt = _runtime(cfg, params, policy=SC, cache_max_bytes=2**24, max_wait_s=1.0)
    try:
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        first = [f.result(timeout=WAIT_S) for f in futs]
        _wait_insertions(rt, len(clouds))
        second = [f.result(timeout=WAIT_S) for f in [rt.submit(c) for c in clouds]]
    finally:
        rt.stop()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    skipped = [b for b in rt.metrics.batch_records if b.preprocess_skipped]
    assert skipped and all(b.n_real == MAX_BATCH for b in skipped)


def test_partial_all_hit_sc_batch_equals_infer_of_the_padded_batch(cfg):
    """An all-hit SC batch with filler rows (1 request, 3 filler rows) answers
    bitwise as the port's `infer` of the padded batch, with every 1-D param
    (biases, LayerNorm gains and shifts) drawn N(0, 2^2), as a trained net's
    are nonzero.  Under SC the activation scale spans the whole batch, so
    the filler rows must carry the zero filler cloud's preprocessing (what
    `infer` computes for them), not zeros.

    The JAX runtime still fills zeros, so on such batches the port differs
    from it by up to ~4e-4, inside SC_LOGIT_ATOL (1e-3) and not checked
    here (ROADMAP.md queue C, fault 1).
    """
    params = get_accelerator(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in params.parameters():
            if p.ndim == 1:
                p.copy_(torch.from_numpy(rng.normal(0.0, 2.0, p.shape).astype(np.float32)))
    cloud = _clouds(1, seed=23)
    with _runtime(cfg, params, policy=SC, cache_max_bytes=2**24) as rt:
        first = _serial(rt, cloud)
        _wait_insertions(rt, 1)
        second = _serial(rt, cloud)
        skipped = [b for b in rt.metrics.batch_records if b.preprocess_skipped]
    want, _, _ = _direct(cfg, params, cloud, SC)
    assert len(skipped) == 1 and skipped[0].n_real == 1
    np.testing.assert_array_equal(first[0], want[0])
    np.testing.assert_array_equal(second[0], want[0])


def test_cache_isolated_per_policy(cfg, params):
    clouds = _clouds(2, seed=22)
    with _runtime(cfg, params, cache_max_bytes=2**24) as rt:
        fp32 = _serial(rt, clouds)
        sc = _serial(rt, clouds, policy=SC)
        _wait_insertions(rt, 2 * len(clouds))
        stats = rt.cache_stats()
    assert stats.entries == 2 * len(clouds)
    assert not np.array_equal(fp32[0], sc[0])


# -- replica pool ----------------------------------------------------------------


def _warm_mb(cfg, policy=None):
    return MicroBatch(requests=(), bucket=cfg.n_points, policy=resolve_policy(cfg, policy),
                      batch=np.zeros((MAX_BATCH, cfg.n_points, 3), np.float32))


def test_replicas_copy_the_params_and_spread_the_load(cfg, params):
    before = [p.clone() for p in params.parameters()]
    pool = ReplicaPool(cfg, params, n_replicas=2, device="cpu", metrics=ServeMetrics())
    try:
        assert all(r.params is not params for r in pool.replicas)
        assert pool.replicas[0].params is not pool.replicas[1].params
        futs = [pool.submit(_warm_mb(cfg)) for _ in range(4)]
        for f in futs:
            assert f.result(timeout=WAIT_S).shape == (MAX_BATCH, cfg.n_classes)
        deadline = time.monotonic() + WAIT_S
        while len(pool.metrics.batch_records) < len(futs):  # recorded after the result
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert {b.replica_id for b in pool.metrics.batch_records} == {0, 1}
    finally:
        pool.shutdown()
    for p, q in zip(params.parameters(), before):
        assert torch.equal(p, q)


def test_heartbeat_eviction_retries_the_inflight_batch(cfg, params):
    """A wedged replica misses heartbeats, is evicted, and its in-flight batch
    completes on the survivor.  The timeout must exceed the worst batch
    latency, here a smoke batch on a loaded CPU."""
    metrics = ServeMetrics()
    pool = ReplicaPool(cfg, params, n_replicas=2, device="cpu", heartbeat_timeout_s=2.0,
                       max_retries=2, metrics=metrics)
    try:
        pool.replicas[0].submit(time.sleep, 6.0)  # wedge replica 0's worker
        out = pool.submit(_warm_mb(cfg)).result(timeout=WAIT_S)
        assert out.shape == (MAX_BATCH, cfg.n_classes)
        deadline = time.monotonic() + WAIT_S
        while pool.replicas[0].alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not pool.replicas[0].alive and pool.replicas[1].alive
        assert metrics.evictions == 1 and metrics.retries >= 1
        assert [b.replica_id for b in metrics.batch_records] == [1]
        assert pool.rejoin(0) and pool.replicas[0].alive
        assert metrics.rejoins == 1
    finally:
        pool.shutdown()


def test_all_replicas_dead_fails_the_future(cfg, params):
    pool = ReplicaPool(cfg, params, n_replicas=1, device="cpu", metrics=ServeMetrics())
    try:
        pool.evict(0, reason="test")
        with pytest.raises(NoReplicaAvailable):
            pool.submit(_warm_mb(cfg)).result(timeout=WAIT_S)
    finally:
        pool.shutdown()


def test_pool_devices():
    assert pool_devices(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pool_devices()


# -- the control-plane options --------------------------------------------------------

# RuntimeConfig option -> (a value, the runtime attribute it builds, its type)
CONTROL_PLANE = {
    "autoscaler": (AutoscalerConfig(poll_interval_s=3600.0), "autoscaler", Autoscaler),
    "adaptive": (AdaptiveConfig(poll_interval_s=3600.0), "controller", AdaptiveController),
    "prometheus_port": (0, "metrics_server", MetricsServer),
    "report_interval_s": (3600.0, "reporter", Reporter),
}


@pytest.mark.parametrize("option", sorted(CONTROL_PLANE))
def test_control_plane_option_builds_its_component(cfg, params, option):
    """Each option builds its component on a CPU runtime, which starts it with
    the runtime and stops it with the runtime; unset, there is none."""
    value, attr, kind = CONTROL_PLANE[option]
    plain = _runtime(cfg, params)
    try:
        assert getattr(plain, attr) is None
    finally:
        plain.stop()
    rt = _runtime(cfg, params, **{option: value})
    try:
        part = getattr(rt, attr)
        assert isinstance(part, kind)
        rt.start()
        if option == "prometheus_port":
            assert part.port != 0 and part._server is not None
        else:
            assert part._thread is not None and part._thread.is_alive()
        assert rt.submit(_clouds(1)[0]).result(timeout=WAIT_S).shape == (cfg.n_classes,)
    finally:
        rt.stop()
    if option == "prometheus_port":
        assert part._server is None
    else:
        assert part._thread is None
    if option == "report_interval_s":
        assert part.ticks == 1 and part.last_snapshot.completed == 1  # the final tick


# option -> a malformed value for the port, and the JAX package's counterpart
MALFORMED = {
    "autoscaler": (lambda: AutoscalerConfig(min_replicas=0),
                   lambda: JAutoscalerConfig(min_replicas=0)),
    "adaptive": (lambda: AdaptiveConfig(rollback_factor=1.0),
                 lambda: JAdaptiveConfig(rollback_factor=1.0)),
    "prometheus_port": (lambda: -1, lambda: -1),
    "report_interval_s": (lambda: 0.0, lambda: 0.0),
}


@pytest.mark.parametrize("option", sorted(MALFORMED))
def test_control_plane_option_rejects_a_malformed_value(cfg, params, bridged, option):
    """A malformed value raises the JAX package's ValueError, at the same step:
    building the option's config, the RuntimeConfig, or the runtime."""
    port_value, jax_value = MALFORMED[option]

    def port():
        return _runtime(cfg, params, **{option: port_value()})

    def reference():
        return JServingRuntime(j_cls_smoke(), bridged["cls"][0], JRuntimeConfig(
            max_batch=MAX_BATCH, buckets=(256,), **{option: jax_value()}))

    with pytest.raises(ValueError) as got:
        port()
    with pytest.raises(ValueError) as want:
        reference()
    assert str(got.value) == str(want.value)


def test_devices_per_replica_carves_the_groups(cfg, params):
    """devices=[cpu] * 4 in groups of 2 gives two replicas, one a pair; a
    group of 3 leaves the fourth device unused; a group larger than the
    device list raises carve_device_groups' ValueError."""
    cpu = torch.device("cpu")
    pool = ReplicaPool(cfg, params, devices=["cpu"] * 4, devices_per_replica=2)
    try:
        assert [r.devices for r in pool.replicas] == [(cpu, cpu), (cpu, cpu)]
        assert all(r.device == cpu and len(r.mesh_params) == 2 for r in pool.replicas)
    finally:
        pool.shutdown()
    rt = ServingRuntime(cfg, params, RuntimeConfig(max_batch=6, devices_per_replica=3),
                        devices=["cpu"] * 4)
    try:
        assert [r.devices for r in rt.pool.replicas] == [(cpu,) * 3]
        assert "cpu+cpu+cpu" in repr(rt)
    finally:
        rt.stop(drain=False)
    with pytest.raises(ValueError, match="exceeds"):
        ReplicaPool(cfg, params, devices=["cpu"] * 2, devices_per_replica=3)
    with pytest.raises(ValueError, match="not both"):
        ReplicaPool(cfg, params, device="cpu", devices=["cpu"])


def test_sharded_policies_are_served(cfg, params, bridged):
    """A sharded default policy and a sharded per-request policy are served,
    each response bitwise the single-device infer of its padded batch; a
    max_batch that the group does not divide raises the JAX package's
    ValueError."""
    sharded = ExecutionPolicy(sharding="batch")
    clouds = _clouds(MAX_BATCH, sizes=(256, 150, 300), seed=21)
    rt = ServingRuntime(cfg, params, RuntimeConfig(max_batch=MAX_BATCH, max_wait_s=0.005,
                                                   buckets=(256,), devices_per_replica=2),
                        policy=sharded, devices=["cpu"] * 2)
    outs = _serve_once(rt, clouds)
    direct, _, _ = _direct(cfg, params, clouds)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, direct[i])
    rt = _runtime(cfg, params)
    tensor_sc = ExecutionPolicy(quant="sc_w16a16", sharding="tensor")
    outs = _serve_once(rt, clouds, policy=tensor_sc)
    direct, _, _ = _direct(cfg, params, clouds, SC)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, direct[i])
    with pytest.raises(ValueError) as got:
        ServingRuntime(cfg, params, RuntimeConfig(max_batch=3, devices_per_replica=2),
                       devices=["cpu"] * 2)
    with pytest.raises(ValueError) as want:
        JServingRuntime(j_cls_smoke(), bridged["cls"][0],
                        JRuntimeConfig(max_batch=3, devices_per_replica=2))
    assert str(got.value) == str(want.value)


def test_every_emitted_trace_event_is_declared():
    """The registry is closed in both directions: every event literal in the
    port's serving modules (subpackages included) and its graph layer is
    declared in EVENTS, and every declared name is used by some module other
    than trace.py."""
    lit = re.compile(
        r"""["']((?:request|batch|graph|replica|scale|chaos|cache|adapt)\.[a-z_]+)["']""")
    used = {}
    for path in [*sorted(SERVE_SRC.rglob("*.py")), SERVE_SRC.parent / "core" / "graphs.py"]:
        for name in lit.findall(path.read_text()):
            used.setdefault(name, set()).add(path.name)
    undeclared = sorted(set(used) - set(EVENTS))
    assert used and undeclared == [], undeclared
    orphans = [name for name in EVENTS if not used.get(name, set()) - {"trace.py"}]
    assert orphans == [], f"EVENTS entries never emitted: {orphans}"
    assert len(EVENTS) == len(set(EVENTS))


def test_traced_runtime_emits_one_terminal_per_request(cfg, params):
    from repro_torch.serve import TERMINAL_EVENTS, TraceConfig

    rt = _runtime(cfg, params, trace=TraceConfig())
    _serve_once(rt, _clouds(3, seed=9))
    events = rt.tracer.events()
    terminals = [e for e in events if e.name in TERMINAL_EVENTS]
    assert len(terminals) == 3 and {e.name for e in terminals} == {"request.completed"}
    names = {e.name for e in events}
    assert {"request.submit", "batch.assembled", "batch.execute_start",
            "batch.completed"} <= names
