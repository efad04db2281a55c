"""Port parity, the five comparison corners through the serving runtime on the CPU:
baseline1/standard, baseline2/standard, pc2im/standard, baseline1/delayed and
baseline2/delayed, for the pointnet2-cls and -seg smoke configs, float and
SC W16A16.

`ServingRuntime(corner_cfg, params, RuntimeConfig(...), device="cpu")` serves
ragged clouds (padded up, exact, subsampled down) under the sequential and
the pipelined schedule, through the preprocess cache cold and then all hits
(a full all-hit batch, and one request alone, whose batch carries three
filler rows: ROADMAP queue C, fault 1), and through a chaos kill of one of
two replicas with a warm rejoin.  Every response is held bitwise against
the port's `infer` of the padded batch the runtime's trace says it rode in
(tests/_port.py), the runtime's contract; that `infer` is held against the
JAX forward in every corner by tests/test_torch_baselines.py.

Each corner serves its own config, so its cache holds only its own
payloads: baseline-2's invalid-centroid rows and standard aggregation's
grouped rows, re-stacked with the zero filler cloud's preprocessing.

Every blocking wait carries a timeout and every runtime stops in a
`finally`, so a hang fails one test instead of the suite.
"""

import numpy as np
import pytest

from _port import (
    CORNER_IDS,
    CORNERS,
    MAX_BATCH,
    MODELS,
    QUANTS,
    WAIT_S,
    assert_served_bitwise,
    corner_configs,
    port_params,
    ragged_clouds,
    wait_for,
    wait_records,
)
from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.serve import (
    AutoscalerConfig,
    ChaosInjector,
    Fault,
    RuntimeConfig,
    ServingRuntime,
    TraceConfig,
    trace_problems,
)


@pytest.fixture(scope="module")
def params():
    """The reference's smoke params of each model, bridged once: the tree is the
    same in every corner."""
    return {m: port_params(m) for m in MODELS}


def _runtime(cfg, params, policy=None, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_s", 1.0)  # batches queued before start flush full
    kw.setdefault("buckets", (cfg.n_points,))
    kw.setdefault("trace", TraceConfig())
    return ServingRuntime(cfg, params, RuntimeConfig(**kw), policy=policy, device="cpu")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("preproc,aggregation", CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("model", list(MODELS))
def test_sequential_and_pipelined_responses_equal_infer(params, model, preproc, aggregation,
                                                        quant):
    """Eight ragged clouds under each schedule, side by side in one runtime: every
    response is the port's infer of its padded batch, and the pipelined
    responses equal the sequential ones (the same clouds in the same batches)."""
    _, cfg = corner_configs(model, preproc, aggregation)
    seq = ExecutionPolicy(quant=quant)
    pip = ExecutionPolicy(quant=quant, pipeline="pipelined")
    clouds = ragged_clouds(2 * MAX_BATCH, seed=1) * 2
    policies = [seq] * (2 * MAX_BATCH) + [pip] * (2 * MAX_BATCH)
    rt = _runtime(cfg, params[model])
    try:
        rt.warmup((seq, pip))
        futs = [rt.submit(c, policy=p) for c, p in zip(clouds, policies)]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        wait_records(rt, len(clouds))
    finally:
        rt.stop()
    snap = rt.metrics.snapshot()
    assert snap.completed == len(clouds) and snap.failed == 0 and snap.retries == 0
    assert {b.policy_key[2] for b in rt.metrics.batch_records if b.n_real} == {
        "sequential", "pipelined"}
    assert assert_served_bitwise(cfg, params[model], rt, clouds, outs, policies) == 4
    for a, b in zip(outs[:2 * MAX_BATCH], outs[2 * MAX_BATCH:]):
        np.testing.assert_array_equal(a, b)
    assert trace_problems(rt.tracer.events()) == []


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("preproc,aggregation", CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("model", list(MODELS))
def test_cache_cold_then_all_hit_with_filler_rows(params, model, preproc, aggregation, quant):
    """A full batch cold (all misses), the same clouds again (all hits), then one of
    them alone: an all-hit batch of one real row and three filler rows, which
    must carry the zero filler cloud's preprocessing.  Every response is the
    port's infer of its padded batch."""
    _, cfg = corner_configs(model, preproc, aggregation)
    cold = ragged_clouds(MAX_BATCH, seed=2)
    clouds = cold + cold + cold[:1]
    policy = ExecutionPolicy(quant=quant)
    rt = _runtime(cfg, params[model], policy=policy, max_wait_s=0.005,
                  cache_max_bytes=1 << 24)
    try:
        rt.warmup()
        futs = [rt.submit(c) for c in cold]
        rt.start()  # queued before start: one full batch
        outs = [f.result(timeout=WAIT_S) for f in futs]
        wait_for(lambda: rt.cache.stats().insertions >= MAX_BATCH, "cache fills")
        futs = [rt.submit(c) for c in cold]
        outs += [f.result(timeout=WAIT_S) for f in futs]
        outs.append(rt.infer(cold[0]))
        records = wait_records(rt, len(clouds))
        stats = rt.cache_stats()
    finally:
        rt.stop()
    assert stats.entries == MAX_BATCH
    skipped = [b for b in records if b.n_real and b.preprocess_skipped]
    assert skipped and skipped[-1].n_real == 1  # the last: one real row, three fillers
    assert sum(b.n_real for b in skipped) == MAX_BATCH + 1  # the second wave and the lone one
    assert_served_bitwise(cfg, params[model], rt, clouds, outs, [policy] * len(clouds))
    for a, b in zip(outs[:MAX_BATCH], outs[MAX_BATCH:2 * MAX_BATCH]):
        np.testing.assert_array_equal(a, b)  # the same full batch, missed then hit


@pytest.mark.parametrize("preproc,aggregation", CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("model,quant", [("cls", "sc_w16a16"), ("seg", "none")])
def test_chaos_kill_and_warm_rejoin(params, model, quant, preproc, aggregation):
    """Replica 1 is killed at its second real batch; the batch retries on replica
    0, the autoscaler rejoins the slot warm and a second wave runs on both.
    Every response is the port's infer of its padded batch, and none fails."""
    _, cfg = corner_configs(model, preproc, aggregation)
    wave1, wave2 = ragged_clouds(4 * MAX_BATCH, seed=3), ragged_clouds(2 * MAX_BATCH, seed=4)
    policy = ExecutionPolicy(quant=quant)
    rt = _runtime(cfg, params[model], policy=policy, n_replicas=2,
                  autoscaler=AutoscalerConfig(poll_interval_s=0.02, rejoin_delay_s=0.05,
                                              min_replicas=2))
    chaos = ChaosInjector([Fault(replica_id=1, at_batch=1, kind="kill")]).attach(rt.pool)
    try:
        rt.warmup()
        futs = [rt.submit(c) for c in wave1]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        wait_for(lambda: rt.metrics.rejoins >= 1, "the rejoin")
        futs = [rt.submit(c) for c in wave2]
        outs += [f.result(timeout=WAIT_S) for f in futs]
        wait_records(rt, len(wave1) + len(wave2))
    finally:
        rt.stop()
    assert [(e.kind, e.replica_id) for e in chaos.fired()] == [("kill", 1)]
    assert ("rejoin", 1) in [(e.action, e.replica_id) for e in rt.autoscaler.events]
    snap = rt.metrics.snapshot()
    assert snap.completed == len(wave1) + len(wave2) and snap.failed == 0
    assert snap.evictions == 1 and snap.retries >= 1 and snap.rejoins == 1
    assert trace_problems(rt.tracer.events()) == []
    assert_served_bitwise(cfg, params[model], rt, wave1 + wave2, outs,
                          [policy] * len(outs))
