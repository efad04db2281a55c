"""Port parity, the fault injector (serve/chaos.py) and the autoscaler
(serve/autoscaler.py) on the CPU.

  * the same Fault lists fire at the same (replica, batch index) in both
    packages over stub pools, with the same trace events and errors;
  * the same scripted queue depths, evictions, deadline slack and sheds,
    under one injected clock, give the same ScaleEvent sequence in both
    packages' autoscalers (fakes after the JAX package's own tests);
  * on the port's CPU ReplicaPool: rejoin after the dwell, retired slots
    stay down, scale-up revives a retired slot, scale-down after sustained
    shallow polls;
  * on a CPU ServingRuntime: a chaos kill and the autoscaler's rejoin, and a
    wedge that trips the heartbeat and rejoins, answer every request.

Tolerances and why: the event sequences are compared for equality (the same
Python over the same inputs and clock).  A response is bitwise equal to the
port's `infer` of the padded batch it rode in (the runtime's contract, read
from the trace), and within 1e-5 (float) and 1e-3 (SC, SC_LOGIT_ATOL) of the
JAX runtime on the same clouds, the bounds tests/test_torch_serve.py states.

Timer-driven loops are driven through `poll_once`; every blocking wait
carries its own timeout and every pool and runtime stops in a `finally`.
"""

import time

import jax
import numpy as np
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro.serve import RuntimeConfig as JRuntimeConfig
from repro.serve import ServingRuntime as JServingRuntime
from repro.serve import autoscaler as j_autoscaler
from repro.serve import chaos as j_chaos
from repro.serve import metrics as j_metrics
from repro.serve import trace as j_trace
from repro_torch.configs import get_config
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.params import from_jax_params
from repro_torch.serve import (
    AutoscalerConfig,
    ChaosInjector,
    Fault,
    MicroBatch,
    ReplicaPool,
    RuntimeConfig,
    ServeMetrics,
    ServingRuntime,
    TraceConfig,
    assemble_batch,
    trace_problems,
)
from repro_torch.serve import autoscaler as t_autoscaler
from repro_torch.serve import chaos as t_chaos
from repro_torch.serve import metrics as t_metrics
from repro_torch.serve import trace as t_trace
from repro_torch.serve.queue import Request

jax.config.update("jax_platform_name", "cpu")

WAIT_S = 60
MAX_BATCH = 4
FLOAT_ATOL = 1e-5
SC_LOGIT_ATOL = 1e-3
PACKAGES = {
    "port": (t_chaos, t_autoscaler, t_metrics, t_trace),
    "jax": (j_chaos, j_autoscaler, j_metrics, j_trace),
}


# -- chaos over stub pools ---------------------------------------------------------


class _StubRep:
    def __init__(self, rid, alive=True):
        self.id = rid
        self.alive = alive


class _StubPool:
    def __init__(self, tracer):
        self.tracer = tracer
        self.evictions = []

    def evict(self, rid, *, reason):
        self.evictions.append((rid, reason))


class _StubMB:
    n_real = 1

    def __init__(self, batch_id):
        self.batch_id = batch_id


def _chaos_run(pkg):
    """Feed one scripted batch sequence through a package's injector."""
    chaos_mod, _, _, trace_mod = PACKAGES[pkg]
    F = chaos_mod.Fault
    faults = [F(1, 2, "kill"), F(1, 2, "kill"), F(0, 1, "slow", 0.001),
              F(0, 3, "wedge", 0.001), F(2, 0, "wedge", 0.001), F(3, 5, "kill")]
    chaos = chaos_mod.ChaosInjector(faults)
    tracer = trace_mod.Tracer(trace_mod.TraceConfig())
    pool = _StubPool(tracer)
    assert chaos.attach(pool) is chaos and pool.chaos is chaos
    reps = {0: _StubRep(0), 1: _StubRep(1), 2: _StubRep(2, alive=False), 3: _StubRep(3)}
    order = np.random.default_rng(5).integers(0, 4, size=40)
    outcomes = []
    for k, rid in enumerate(order):
        if k == 20:
            chaos.add(F(0, 9, "kill"))  # declared mid-run
        try:
            chaos.on_batch(pool, reps[int(rid)], _StubMB(k))
            outcomes.append("ok")
        except chaos_mod.ChaosError as e:
            outcomes.append(str(e))
    events = [(e.kind, e.replica_id, e.batch_index) for e in chaos.fired()]
    traced = [(e.name, e.replica_id, e.batch_id, e.args) for e in tracer.events()]
    return outcomes, events, pool.evictions, traced, [e.kind for e in chaos.fired("kill")]


def test_faults_fire_at_the_same_batches_as_the_jax_package():
    got, want = _chaos_run("port"), _chaos_run("jax")
    assert got == want
    outcomes, events, evictions, traced, kills = got
    assert {k for k, _, _ in events} == {"kill", "slow", "wedge"}
    assert ("kill", 1, 2) in events and events.count(("kill", 1, 2)) == 1  # at most once
    assert ("wedge", 2, 0) in events and "wedged at batch 0" in " ".join(outcomes)
    assert evictions and all(reason == "chaos-kill" for _, reason in evictions)
    assert len(traced) == len(events) and len(kills) == len(evictions)


@pytest.mark.parametrize("kw", [
    {"replica_id": 0, "at_batch": 0, "kind": "melt"},
    {"replica_id": 0, "at_batch": -1},
    {"replica_id": 0, "at_batch": 0, "kind": "wedge"},
    {"replica_id": 0, "at_batch": 0, "kind": "slow", "duration_s": -1.0},
])
def test_fault_validation_equals_the_jax_package(kw):
    with pytest.raises(ValueError) as got:
        t_chaos.Fault(**kw)
    with pytest.raises(ValueError) as want:
        j_chaos.Fault(**kw)
    assert str(got.value) == str(want.value)


# -- the autoscaler over fakes, one injected clock ------------------------------


class _Clock:
    """A manual time.monotonic; `sleep` stays real."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    sleep = staticmethod(time.sleep)


class _FakeReplica:
    def __init__(self, rid):
        self.id = rid
        self.alive = True
        self.retired = False
        self.evicted_t = None


class _FakePool:
    """The JAX package's cost-signal fake pool, plus fault evictions and a
    rejoin that fails on demand."""

    def __init__(self, clock, n):
        self.clock = clock
        self.replicas = [_FakeReplica(i) for i in range(n)]
        self.fail_rejoins = 0

    def alive_replicas(self):
        return [r for r in self.replicas if r.alive]

    def add_replica(self):
        rid = len(self.replicas)
        self.replicas.append(_FakeReplica(rid))
        return rid

    def evict(self, rid):
        rep = self.replicas[rid]
        rep.alive, rep.evicted_t = False, self.clock.t

    def rejoin(self, rid):
        if self.replicas[rid].alive:
            return False
        if self.fail_rejoins:
            self.fail_rejoins -= 1
            raise RuntimeError("warmup replay failed")
        self.replicas[rid].alive = True
        self.replicas[rid].retired = False
        return True

    def retire(self, rid):
        rep = self.replicas[rid]
        if not rep.alive:
            return False
        rep.alive, rep.retired, rep.evicted_t = False, True, self.clock.t
        return True


class _FakeQueue:
    def __init__(self):
        self.d, self.slack = 0, {}

    def depth(self):
        return self.d

    def slack_by_class(self, now=None):
        return dict(self.slack)


def _autoscaler_run(pkg, monkeypatch, seed):
    """A scripted run of one package's Autoscaler, driven by poll_once."""
    _, scaler_mod, metrics_mod, trace_mod = PACKAGES[pkg]
    clock = _Clock()
    monkeypatch.setattr(scaler_mod, "time", clock)
    pool, queue, metrics = _FakePool(clock, 2), _FakeQueue(), metrics_mod.ServeMetrics()
    tracer = trace_mod.Tracer(trace_mod.TraceConfig())
    cfg = scaler_mod.AutoscalerConfig(
        poll_interval_s=0.05, rejoin_delay_s=0.2, scale_up_depth=6.0, scale_down_depth=1.0,
        scale_down_ticks=4, min_replicas=1, max_replicas=4, cooldown_s=0.3,
        slack_scale_up_s=0.05, shed_scale_up_rate=20.0)
    scaler = scaler_mod.Autoscaler(pool, queue, cfg, tracer=tracer, metrics=metrics)
    rng = np.random.default_rng(seed)
    for step in range(160):
        phase = (step // 20) % 4
        queue.d = int(rng.integers(0, 3) if phase in (0, 2) else rng.integers(0, 40))
        queue.slack = ({"interactive": float(rng.uniform(0.0, 0.2)), "bulk": 5.0}
                       if phase == 2 else {})
        if phase == 3 and rng.random() < 0.3:
            for _ in range(int(rng.integers(1, 8))):
                metrics.record_shed()
        alive = [r.id for r in pool.replicas if r.alive]
        if alive and rng.random() < 0.06:
            pool.evict(int(rng.choice(alive)))
        if step in (30, 90):
            pool.fail_rejoins = 1
        clock.t += float(rng.choice([0.05, 0.1, 0.25]))
        scaler.poll_once()
    events = [(e.action, e.replica_id, e.depth, e.t, e.reason) for e in scaler.events]
    traced = [(e.name, e.replica_id, e.args) for e in tracer.events()]
    return events, traced


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_events_equal_the_jax_package(monkeypatch, seed):
    got = _autoscaler_run("port", monkeypatch, seed)
    want = _autoscaler_run("jax", monkeypatch, seed)
    assert got == want
    actions = {a for a, *_ in got[0]}
    reasons = {r.split(":")[0] for a, *_, r in got[0] if a == "scale_up"}
    assert {"rejoin", "scale_up", "scale_down"} <= actions, actions
    assert reasons & {"depth", "slack", "shed"}
    assert len(got[1]) == len(got[0])


@pytest.mark.parametrize("kw", [
    {"poll_interval_s": 0.0}, {"min_replicas": 0}, {"min_replicas": 2, "max_replicas": 1},
    {"scale_up_depth": 1.0, "scale_down_depth": 2.0}, {"slack_scale_up_s": 0.0},
    {"shed_scale_up_rate": -1.0},
])
def test_autoscaler_config_validation_equals_the_jax_package(kw):
    with pytest.raises(ValueError) as got:
        AutoscalerConfig(**kw)
    with pytest.raises(ValueError) as want:
        j_autoscaler.AutoscalerConfig(**kw)
    assert str(got.value) == str(want.value)


# -- the autoscaler over the port's CPU pool ------------------------------------


@pytest.fixture(scope="module")
def bridged():
    """JAX params of the cls smoke config and the same weights in the port."""
    jp = JPN.init_params(jax.random.PRNGKey(0), j_cls_smoke())
    tcfg = get_config("pointnet2-cls", smoke=True)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def cfg():
    return get_config("pointnet2-cls", smoke=True)  # n_points=256


@pytest.fixture(scope="module")
def params(bridged):
    return bridged[1]


class _Depth:
    def __init__(self, d=0):
        self.d = d

    def depth(self):
        return self.d


def _pool(cfg, params, n=2):
    return ReplicaPool(cfg, params, n_replicas=n, device="cpu", metrics=ServeMetrics())


def test_rejoins_fault_evicted_after_delay(cfg, params):
    pool = _pool(cfg, params)
    try:
        scaler = t_autoscaler.Autoscaler(pool, _Depth(), AutoscalerConfig(rejoin_delay_s=60.0))
        pool.evict(1, reason="test")
        scaler.poll_once()  # a 60 s dwell cannot have elapsed
        assert not pool.replicas[1].alive
        pool.replicas[1].evicted_t -= 120.0  # rewind the eviction instead of waiting
        scaler.poll_once()
        assert pool.replicas[1].alive
        assert [e.action for e in scaler.events] == ["rejoin"]
    finally:
        pool.shutdown()


def test_retired_replicas_stay_down(cfg, params):
    pool = _pool(cfg, params)
    try:
        scaler = t_autoscaler.Autoscaler(pool, _Depth(), AutoscalerConfig(rejoin_delay_s=0.0))
        pool.retire(1)
        scaler.poll_once()
        assert not pool.replicas[1].alive and scaler.events == []
    finally:
        pool.shutdown()


def test_scale_up_revives_a_retired_slot_under_load(cfg, params):
    pool = _pool(cfg, params)
    try:
        queue = _Depth()
        scaler = t_autoscaler.Autoscaler(
            pool, queue, AutoscalerConfig(scale_up_depth=4.0, cooldown_s=0.0))
        pool.retire(1)
        queue.d = 8  # 8 deep on one alive replica
        scaler.poll_once()
        assert pool.replicas[1].alive and not pool.replicas[1].retired
        assert [(e.action, e.replica_id, e.reason) for e in scaler.events] == [
            ("scale_up", 1, "depth")]
    finally:
        pool.shutdown()


def test_scale_down_after_sustained_shallow(cfg, params):
    pool = _pool(cfg, params)
    try:
        scaler = t_autoscaler.Autoscaler(
            pool, _Depth(), AutoscalerConfig(scale_down_ticks=3, min_replicas=1, cooldown_s=0.0))
        scaler.poll_once()
        scaler.poll_once()
        assert len(pool.alive_replicas()) == 2  # not sustained yet
        scaler.poll_once()
        assert len(pool.alive_replicas()) == 1 and pool.replicas[1].retired
        for _ in range(5):
            scaler.poll_once()  # the min_replicas floor holds
        assert len(pool.alive_replicas()) == 1
        assert [e.action for e in scaler.events] == ["scale_down"]
    finally:
        pool.shutdown()


def test_scale_up_grows_a_slot_up_to_max_replicas(cfg, params):
    pool = _pool(cfg, params, n=1)
    try:
        scaler = t_autoscaler.Autoscaler(
            pool, _Depth(100), AutoscalerConfig(scale_up_depth=1.0, cooldown_s=0.0))
        scaler.poll_once()
        assert len(pool.replicas) == 1  # no new slot without max_replicas
        scaler.config = AutoscalerConfig(scale_up_depth=1.0, cooldown_s=0.0, max_replicas=2)
        scaler.poll_once()
        assert len(pool.replicas) == 2 and pool.replicas[1].alive
    finally:
        pool.shutdown()


# -- chaos and recovery on a CPU runtime ------------------------------------------


def _clouds(k, seed, sizes=(256, 150, 300)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((sizes[i % len(sizes)], 3)).astype(np.float32)
            for i in range(k)]


def _wait_for(pred, what):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _check_against_infer(cfg, params, rt, clouds, outs, policy=None):
    """Each response bitwise equal to the port's infer of the padded batch the
    trace says it rode in (members and bucket of `batch.assembled`)."""
    events = rt.tracer.events()
    order = {e.trace_id: k for k, e in enumerate(e for e in events if e.name == "request.submit")}
    accel = get_accelerator(cfg, policy, device="cpu")
    seen = set()
    for e in events:
        if e.name != "batch.assembled":
            continue
        idx, bucket = [order[t] for t in e.args["members"]], e.args["bucket"]
        reqs = [Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0], bucket=bucket,
                        policy=resolve_policy(cfg, policy), deadline_t=None, submit_t=0.0,
                        future=None) for i in idx]
        want = accel.infer(params, assemble_batch(reqs, bucket, 3, MAX_BATCH)).numpy()
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(outs[i], want[j])
            seen.add(i)
    assert seen == set(range(len(clouds)))


def _jax_serve(jparams, clouds, quant):
    """The same clouds through the JAX runtime, queued before it starts."""
    rt = JServingRuntime(j_cls_smoke(), jparams,
                         JRuntimeConfig(max_batch=MAX_BATCH, max_wait_s=1.0, buckets=(256,)),
                         policy=JPolicy(quant=quant))
    try:
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        return [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        rt.stop()


@pytest.mark.parametrize("quant,atol", [("none", FLOAT_ATOL), ("sc_w16a16", SC_LOGIT_ATOL)])
def test_chaos_kill_rejoins_and_answers_every_request(bridged, cfg, params, quant, atol):
    """Replica 1 is killed at its second real batch; the batch retries on
    replica 0, the autoscaler rejoins the slot warm, and a second wave runs on
    both.  Full batches queued before start keep the batches (and so the SC
    scales) the JAX runtime's."""
    policy = ExecutionPolicy(quant=quant)
    wave1, wave2 = _clouds(16, seed=11), _clouds(8, seed=12)
    rt = ServingRuntime(cfg, params, RuntimeConfig(
        max_batch=MAX_BATCH, max_wait_s=1.0, buckets=(256,), n_replicas=2, trace=TraceConfig(),
        autoscaler=AutoscalerConfig(poll_interval_s=0.02, rejoin_delay_s=0.05,
                                    min_replicas=2)),
        policy=policy, device="cpu")
    chaos = ChaosInjector([Fault(replica_id=1, at_batch=1, kind="kill")]).attach(rt.pool)
    try:
        rt.warmup()
        futs = [rt.submit(c) for c in wave1]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: rt.metrics.rejoins >= 1, "the rejoin")
        futs = [rt.submit(c) for c in wave2]
        outs += [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= 24, "records")
    finally:
        rt.stop()
    assert [(e.kind, e.replica_id, e.batch_index) for e in chaos.fired()] == [("kill", 1, 1)]
    assert [(e.action, e.replica_id) for e in rt.autoscaler.events] == [("rejoin", 1)]
    snap = rt.metrics.snapshot()
    assert snap.completed == snap.submitted == 24 and snap.failed == 0
    assert snap.evictions == 1 and snap.retries >= 1 and snap.rejoins == 1
    real = [b for b in rt.metrics.batch_records if b.n_real]
    assert sum(b.n_real for b in real) == 24 and {b.replica_id for b in real[-2:]} == {0, 1}
    assert trace_problems(rt.tracer.events()) == []
    _check_against_infer(cfg, params, rt, wave1 + wave2, outs, policy)
    want = _jax_serve(bridged[0], wave1, quant)
    for g, w in zip(outs[:16], want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def test_wedge_trips_the_heartbeat_and_rejoins(cfg, params):
    """A wedged worker is evicted by the liveness monitor, its batch retries on
    the survivor, and the autoscaler brings the slot back.  The heartbeat
    timeout exceeds the worst batch latency of a smoke batch on a loaded CPU."""
    clouds = _clouds(8, seed=13)
    rt = ServingRuntime(cfg, params, RuntimeConfig(
        max_batch=MAX_BATCH, buckets=(256,), n_replicas=2, heartbeat_timeout_s=2.0,
        trace=TraceConfig(),
        autoscaler=AutoscalerConfig(poll_interval_s=0.02, rejoin_delay_s=0.05,
                                    min_replicas=2)), device="cpu")
    chaos = ChaosInjector([Fault(0, 0, kind="wedge", duration_s=4.0)]).attach(rt.pool)
    try:
        rt.warmup()
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        _wait_for(lambda: rt.metrics.rejoins >= 1, "the rejoin")
        _wait_for(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= 8, "records")
    finally:
        rt.stop()
    assert [(e.kind, e.replica_id) for e in chaos.fired()] == [("wedge", 0)]
    assert ("rejoin", 0) in [(e.action, e.replica_id) for e in rt.autoscaler.events]
    snap = rt.metrics.snapshot()
    assert snap.completed == 8 and snap.evictions >= 1 and snap.rejoins >= 1
    evicted = [e for e in rt.tracer.events() if e.name == "replica.evicted"]
    assert evicted[0].replica_id == 0 and evicted[0].args["reason"] == "heartbeat"
    _check_against_infer(cfg, params, rt, clouds, outs)


def test_attach_installs_the_pool_hook(cfg, params):
    pool = _pool(cfg, params, n=1)
    try:
        chaos = ChaosInjector().attach(pool)
        assert pool.chaos is chaos
        mb = MicroBatch(requests=(), bucket=256, policy=resolve_policy(cfg, None),
                        batch=np.zeros((MAX_BATCH, 256, 3), np.float32))
        assert pool.submit(mb).result(timeout=WAIT_S).shape == (MAX_BATCH, cfg.n_classes)
        assert chaos.fired() == []  # a batch with no real request is invisible to it
    finally:
        pool.shutdown()
