"""Port parity, the adaptive controller (serve/adapt/) on the CPU.

  * `Histogram`, `padding_waste`, `propose_buckets`, `interarrival_mean` and
    `propose_wait` equal the JAX package's on the same numpy samples;
  * over the JAX package's `_FakeRuntime` (a port copy, one per package) and
    one injected clock, `poll_once` logs the same `Decision` sequence in both
    packages: apply, hysteresis reject, the verify window, rollback, keep,
    max_batch grow and shrink, wait tuning and a swallowed error;
  * on a CPU ServingRuntime, an adaptive bucket swap in the middle of the
    traffic loses no request, and each response is bitwise equal to the
    port's `infer` of its padded batch at its own bucket and within 1e-5
    (float) / 1e-3 (SC) of the JAX runtime driven the same way.

Tolerances and why: the histogram functions and the decisions (evidence
floats included) are compared exactly, with 0 tolerance: both packages run
the same numpy arithmetic on the same samples.  Responses against the JAX
runtime use the bounds tests/test_torch_serve.py states.

The controller is driven through `poll_once` (its thread's period is an
hour); every blocking wait carries its own timeout and every runtime stops
in a `finally`.
"""

import dataclasses
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro.serve import RuntimeConfig as JRuntimeConfig
from repro.serve import ServingRuntime as JServingRuntime
from repro.serve import metrics as j_metrics
from repro.serve import scheduler as j_scheduler
from repro.serve.adapt import controller as j_controller
from repro.serve.adapt import decisions as j_decisions
from repro.serve.adapt import histograms as j_hist
from repro_torch.configs import get_config
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.params import from_jax_params
from repro_torch.serve import (
    AdaptiveConfig,
    AdaptiveController,
    RuntimeConfig,
    ServingRuntime,
    TraceConfig,
    assemble_batch,
    trace_problems,
)
from repro_torch.serve import metrics as t_metrics
from repro_torch.serve import scheduler as t_scheduler
from repro_torch.serve.adapt import controller as t_controller
from repro_torch.serve.adapt import decisions as t_decisions
from repro_torch.serve.adapt import histograms as t_hist
from repro_torch.serve.queue import Request

jax.config.update("jax_platform_name", "cpu")

WAIT_S = 60
MAX_BATCH = 4
FLOAT_ATOL = 1e-5
SC_LOGIT_ATOL = 1e-3
PACKAGES = {
    "port": (t_controller, t_decisions, t_metrics, t_scheduler),
    "jax": (j_controller, j_decisions, j_metrics, j_scheduler),
}


# -- histograms and proposal math ---------------------------------------------------


def _samples(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(40, 200, 300), rng.integers(600, 1500, 80),
                           rng.integers(1, 3000, 20)]).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_equals_the_jax_package(seed):
    sizes = _samples(seed)
    th, jh = t_hist.Histogram(), j_hist.Histogram()
    th.extend(sizes)
    jh.extend(sizes)
    th.add(7, 3)
    jh.add(7, 3)
    assert len(th) == len(jh) == sizes.size + 3
    assert th.mean() == jh.mean()
    for q in np.linspace(0.0, 1.0, 41):
        assert th.quantile(float(q)) == jh.quantile(float(q))
    for bad in (lambda h: h.add(0), lambda h: h.quantile(1.5),
                lambda h: type(h)().quantile(0.5)):
        with pytest.raises(ValueError) as got:
            bad(th)
        with pytest.raises(ValueError) as want:
            bad(jh)
        assert str(got.value) == str(want.value)
    assert t_hist.Histogram().mean() == j_hist.Histogram().mean() == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proposal_math_equals_the_jax_package(seed):
    sizes = _samples(seed)
    rng = np.random.default_rng(seed + 10)
    for buckets in ((256,), (128, 256), (96, 512, 1024), (64, 128, 256, 1024, 2048)):
        assert t_hist.padding_waste(sizes, buckets) == j_hist.padding_waste(sizes, buckets)
    assert t_hist.padding_waste(np.array([], np.int64), (256,)) == 0.0
    for n_buckets in (1, 2, 3, 5):
        for align in (1, 32, 64):
            for lo, hi in ((32, 1024), (128, 2048), (512, 512)):
                kw = dict(align=align, min_bucket=lo, max_bucket=hi)
                assert (t_hist.propose_buckets(sizes, n_buckets, **kw)
                        == j_hist.propose_buckets(sizes, n_buckets, **kw))
    assert t_hist.propose_buckets([], 2, min_bucket=64, max_bucket=256) == (256,)
    for bad in (dict(n_buckets=0, min_bucket=1, max_bucket=2),
                dict(n_buckets=1, align=0, min_bucket=1, max_bucket=2),
                dict(n_buckets=1, min_bucket=4, max_bucket=2)):
        with pytest.raises(ValueError) as got:
            t_hist.propose_buckets(sizes, **bad)
        with pytest.raises(ValueError) as want:
            j_hist.propose_buckets(sizes, **bad)
        assert str(got.value) == str(want.value)
    arrivals = np.cumsum(rng.exponential(0.004, 400))
    for window in (2, 16, 256, 1000):
        assert (t_hist.interarrival_mean(arrivals, window)
                == j_hist.interarrival_mean(arrivals, window))
    assert t_hist.interarrival_mean(arrivals[:1]) is j_hist.interarrival_mean(arrivals[:1])
    for gap in (None, 1e-5, 0.002, 0.5):
        for max_batch in (0, 1, 4, 16):
            for bounds in ((0.001, 0.05), (0.0005, 0.002)):
                assert (t_hist.propose_wait(gap, max_batch, bounds=bounds)
                        == j_hist.propose_wait(gap, max_batch, bounds=bounds))


# -- the controller over fakes, one injected clock ----------------------------------


class _Clock:
    """A manual time.monotonic shared by the controller, its log and the metrics."""

    def __init__(self, t=500.0):
        self.t = t

    def monotonic(self):
        return self.t

    sleep = staticmethod(time.sleep)


class _FakeScheduler:
    def __init__(self, config):
        self.config = config


class _FakeRuntime:
    """The JAX package's controller fake (tests/test_adaptive_control.py),
    over one package's ServeMetrics and SchedulerConfig."""

    def __init__(self, metrics_mod, scheduler_mod, buckets=(256,), max_batch=4, depth=0):
        self.metrics = metrics_mod.ServeMetrics()
        self.buckets = tuple(buckets)
        self.scheduler = _FakeScheduler(scheduler_mod.SchedulerConfig(max_batch=max_batch))
        self.depth = depth
        self.queue = SimpleNamespace(depth=lambda: self.depth)
        self.tracer = None
        self.calls = []
        self.fail_reconfigure = False

    def reconfigure(self, **kw):
        if self.fail_reconfigure:
            raise RuntimeError("injected reconfigure failure")
        self.calls.append(kw)
        if "buckets" in kw:
            self.buckets = tuple(kw["buckets"])
        cfg = self.scheduler.config
        self.scheduler.config = dataclasses.replace(
            cfg, version=cfg.version + 1,
            **{k: v for k, v in kw.items() if k in ("max_batch", "max_wait_s", "class_max_wait")})
        return self.scheduler.config.version


def _controller_run(pkg, monkeypatch, scenario):
    """One scripted scenario through one package's controller; returns its log."""
    ctrl_mod, dec_mod, metrics_mod, sched_mod = PACKAGES[pkg]
    clock = _Clock()
    for mod in (ctrl_mod, dec_mod, metrics_mod):
        monkeypatch.setattr(mod, "time", clock)
    kw = dict(min_samples=32, min_bucket=64, cooldown_s=0.5, observe_s=1.0,
              tune_max_batch=False, tune_wait=False)
    rt = _FakeRuntime(metrics_mod, sched_mod, buckets=(256,), max_batch=8)
    m = rt.metrics

    def tick(dt=0.3):
        clock.t += dt
        ctrl.poll_once()

    def batches(n_real, size, k):
        for _ in range(k):
            m.record_batch(metrics_mod.BatchRecord(bucket=256, policy_key=(), n_real=n_real,
                                                   batch_size=size, replica_id=0,
                                                   duration_s=0.01))

    if scenario == "apply-verify-rollback":
        ctrl = ctrl_mod.AdaptiveController(rt, ctrl_mod.AdaptiveConfig(**kw))
        for s in [100] * 10:
            m.record_arrival(s)
        tick()  # below min_samples: silent
        for i in range(20):
            m.record_completed(0.001 + 1e-5 * i)
        for s in np.random.default_rng(0).integers(60, 120, 100):
            m.record_arrival(int(s))
        tick(0.01)  # apply buckets
        tick()  # inside the verify window
        for i in range(30):
            m.record_completed(0.1 + 1e-3 * i)  # the swap made things worse
        tick(1.5)  # verify: rollback
        tick(0.1)  # cooldown
        tick(1.0)  # proposes again
        for i in range(30):
            m.record_completed(0.001)
        tick(1.5)  # verify keeps it
    elif scenario == "hysteresis":
        ctrl = ctrl_mod.AdaptiveController(rt, ctrl_mod.AdaptiveConfig(
            **{**kw, "waste_improvement": 10.0}))
        for s in [100] * 100:
            m.record_arrival(s)
        tick()
        tick()  # the same rejection is logged once
        for s in [150] * 200:
            m.record_arrival(s)
        tick()  # a different proposal is logged again
    elif scenario == "max_batch":
        ctrl = ctrl_mod.AdaptiveController(rt, ctrl_mod.AdaptiveConfig(
            **{**kw, "tune_max_batch": True, "min_batch_records": 8,
               "max_batch_bounds": (2, 16)}))
        for s in [256] * 64:
            m.record_arrival(s)  # sizes on the bucket: no bucket move
        rt.depth = 16
        batches(8, 8, 10)
        tick()  # grow 8 -> 16
        tick(1.5)  # verify (too few completions to judge): kept
        rt.depth = 0
        batches(1, 16, 10)
        tick(1.0)  # shrink 16 -> 8
        tick(1.5)
        batches(2, 8, 3)
        tick(1.0)  # too few fresh records
    elif scenario == "wait":
        ctrl = ctrl_mod.AdaptiveController(rt, ctrl_mod.AdaptiveConfig(
            **{**kw, "tune_wait": True}))
        for i in range(64):
            clock.t += 0.002 if i % 2 else 0.003
            m.record_arrival(256, "interactive")
            m.record_arrival(256, "bulk")
        tick()
        tick(1.5)
        for i in range(64):
            clock.t += 0.0001
            m.record_arrival(256, "interactive")
        tick(1.0)
    else:  # "error"
        ctrl = ctrl_mod.AdaptiveController(rt, ctrl_mod.AdaptiveConfig(**kw))
        rt.fail_reconfigure = True
        for s in [100] * 100:
            m.record_arrival(s)
        tick()  # must not raise
        rt.fail_reconfigure = False
        tick(1.0)
    log = [(d.kind, d.value, d.previous, d.applied, d.reason, dict(d.evidence), d.t, d.version)
           for d in ctrl.decisions.all()]
    return log, rt.calls, rt.buckets, rt.scheduler.config


@pytest.mark.parametrize("scenario", ["apply-verify-rollback", "hysteresis", "max_batch",
                                      "wait", "error"])
def test_decisions_equal_the_jax_package(monkeypatch, scenario):
    log, calls, buckets, sched = _controller_run("port", monkeypatch, scenario)
    j_log, j_calls, j_buckets, j_sched = _controller_run("jax", monkeypatch, scenario)
    assert log == j_log
    assert calls == j_calls and buckets == j_buckets
    assert dataclasses.astuple(sched) == dataclasses.astuple(j_sched)
    kinds = [(k, applied) for k, _, _, applied, *_ in log]
    expect = {
        "apply-verify-rollback": [("buckets", True), ("rollback", True), ("buckets", True)],
        "hysteresis": [("buckets", False), ("buckets", False)],
        "max_batch": [("max_batch", True), ("max_batch", True)],
        "wait": [("max_wait", True), ("max_wait", True)],
        "error": [("error", False), ("buckets", True)],
    }[scenario]
    assert kinds == expect, kinds


@pytest.mark.parametrize("kw", [
    {"occupancy_low": 0.9, "occupancy_high": 0.5}, {"rollback_factor": 1.0},
    {"max_batch_bounds": (0, 4)}, {"wait_bounds": (0.0, 0.1)}, {"min_samples": 0},
    {"poll_interval_s": 0.0}, {"n_buckets": 0}, {"observe_s": 0.0},
])
def test_adaptive_config_validation_equals_the_jax_package(kw):
    with pytest.raises(ValueError) as got:
        AdaptiveConfig(**kw)
    with pytest.raises(ValueError) as want:
        j_controller.AdaptiveConfig(**kw)
    assert str(got.value) == str(want.value)


# -- a mid-stream swap on a CPU runtime ------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    jp = JPN.init_params(jax.random.PRNGKey(0), j_cls_smoke())
    tcfg = get_config("pointnet2-cls", smoke=True)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _waves(seed):
    """Wave 1: 16 clouds of 100-128 points (served at the 256 bucket before
    the swap, which they make propose (128, 256)); wave 2: 4 clouds of at most
    128 points and 4 larger, after it."""
    rng = np.random.default_rng(seed)
    first = [rng.standard_normal((int(n), 3)).astype(np.float32)
             for n in rng.integers(100, 129, 16)]
    second = [rng.standard_normal((int(n), 3)).astype(np.float32)
              for n in (*rng.integers(70, 129, 4), *rng.integers(140, 400, 4))]
    return first, second


ADAPT = dict(poll_interval_s=3600.0, min_samples=16, min_bucket=64, n_buckets=2,
             tune_max_batch=False, tune_wait=False)


def _drive(rt, controller, wave1, wave2):
    """Wave 1 in flight while the controller swaps buckets, then wave 2."""
    futs = [rt.submit(c) for c in wave1]
    rt.start()
    controller.poll_once()  # the swap, with wave 1 still being served
    futs += [rt.submit(c) for c in wave2]
    return [np.asarray(f.result(timeout=120)) for f in futs]


@pytest.mark.parametrize("quant,atol", [("none", FLOAT_ATOL), ("sc_w16a16", SC_LOGIT_ATOL)])
def test_midstream_swap_loses_nothing_and_matches_infer(bridged, quant, atol):
    jp, tp = bridged
    cfg = get_config("pointnet2-cls", smoke=True)
    policy = ExecutionPolicy(quant=quant)
    wave1, wave2 = _waves(3)
    clouds = wave1 + wave2
    rt = ServingRuntime(cfg, tp, RuntimeConfig(
        max_batch=MAX_BATCH, max_wait_s=1.0, buckets=(256,), n_replicas=2, trace=TraceConfig(),
        adaptive=AdaptiveConfig(**ADAPT)), policy=policy, device="cpu")
    try:
        assert isinstance(rt.controller, AdaptiveController)
        rt.warmup()
        outs = _drive(rt, rt.controller, wave1, wave2)
        deadline = time.monotonic() + WAIT_S
        while sum(b.n_real for b in rt.metrics.batch_records) < len(clouds):
            assert time.monotonic() < deadline
            time.sleep(0.001)
    finally:
        rt.stop()
    (d,) = rt.controller.decisions.all()
    assert (d.kind, d.value, d.previous, d.applied) == ("buckets", (128, 256), (256,), True)
    assert rt.buckets == (128, 256)
    snap = rt.metrics.snapshot()
    assert snap.completed == len(clouds) and snap.failed == snap.rejected == 0
    events = rt.tracer.events()
    assert trace_problems(events) == []
    assert {e.name for e in events} >= {"adapt.propose", "adapt.apply"}
    order = {e.trace_id: k for k, e in enumerate(e for e in events if e.name == "request.submit")}
    accel = get_accelerator(cfg, policy, device="cpu")
    buckets = {}
    for e in events:
        if e.name != "batch.assembled":
            continue
        idx, bucket = [order[t] for t in e.args["members"]], e.args["bucket"]
        reqs = [Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0], bucket=bucket,
                        policy=resolve_policy(cfg, policy), deadline_t=None, submit_t=0.0,
                        future=None) for i in idx]
        want = accel.infer(tp, assemble_batch(reqs, bucket, 3, MAX_BATCH)).numpy()
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(outs[i], want[j])
            buckets[i] = bucket
    assert [buckets[i] for i in range(len(clouds))] == [256] * 16 + [128] * 4 + [256] * 4
    # the JAX runtime, driven the same way
    jrt = JServingRuntime(j_cls_smoke(), jp, JRuntimeConfig(
        max_batch=MAX_BATCH, max_wait_s=1.0, buckets=(256,), n_replicas=2,
        adaptive=j_controller.AdaptiveConfig(**ADAPT)), policy=JPolicy(quant=quant))
    try:
        jrt.warmup()
        want = _drive(jrt, jrt.controller, wave1, wave2)
    finally:
        jrt.stop()
    assert jrt.buckets == rt.buckets
    for g, w in zip(outs, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
