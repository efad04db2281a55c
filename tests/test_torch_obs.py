"""Port parity, the observability exporters (serve/obs.py) on the CPU: the
reductions, the Chrome trace and the Prometheus text against the JAX
package on the same events and snapshots, the Reporter, the MetricsServer,
and a traced CPU runtime whose trace is well formed.

Tolerances and why: none.  Both packages run the same Python and numpy
arithmetic over the same event tuples and the same metric records (with one
scripted clock for the metrics' own time stamps), so timelines, problem
lists, breakdown tables, cross-checks, Chrome-trace JSON and Prometheus text
are compared for equality.

Every blocking wait carries its own timeout and every runtime, reporter and
listener stops in a `finally`.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.serve import metrics as j_metrics_mod
from repro.serve import obs as j_obs
from repro.serve import trace as j_trace
from repro_torch.configs import get_config
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import resolve_policy
from repro_torch.serve import (
    BatchRecord,
    MetricsServer,
    Reporter,
    RuntimeConfig,
    ServeMetrics,
    ServingRuntime,
    TraceConfig,
    Tracer,
    assemble_batch,
    batch_crosscheck,
    trace_problems,
)
from repro_torch.serve import metrics as t_metrics_mod
from repro_torch.serve import obs as t_obs
from repro_torch.serve import trace as t_trace
from repro_torch.serve.queue import Request

WAIT_S = 60
MAX_BATCH = 4

# (name, t, trace_id, batch_id, replica_id, slo, args) of one stream that
# holds a completed, a rejected, a shed, an expired and a failed request, a
# batch killed on replica 1 and retried on replica 0, cache and
# pipelined-stage edges, and control-plane events.
STREAM = (
    ("request.submit", 1.000, 1, -1, -1, "interactive", None),
    ("request.admitted", 1.001, 1, -1, -1, "interactive", None),
    ("request.enqueued", 1.002, 1, -1, -1, "interactive", None),
    ("request.submit", 1.003, 2, -1, -1, "bulk", None),
    ("request.admitted", 1.004, 2, -1, -1, "bulk", None),
    ("request.enqueued", 1.005, 2, -1, -1, "bulk", None),
    ("request.submit", 1.006, 3, -1, -1, "bulk", None),
    ("request.rejected", 1.007, 3, -1, -1, "bulk", {"reason": "full"}),
    ("request.submit", 1.008, 4, -1, -1, "bulk", None),
    ("request.shed", 1.009, 4, -1, -1, "bulk", {"reason": "threshold"}),
    ("request.submit", 1.010, 5, -1, -1, "default", None),
    ("request.admitted", 1.011, 5, -1, -1, "default", None),
    ("request.expired", 1.300, 5, -1, -1, "default", None),
    ("request.drained", 1.100, 1, -1, -1, "interactive", None),
    ("request.drained", 1.101, 2, -1, -1, "bulk", None),
    ("batch.assembled", 1.150, -1, 7, -1, "interactive", {"members": [1, 2], "bucket": 256}),
    ("request.assembled", 1.150, 1, 7, -1, "interactive", None),
    ("request.assembled", 1.150, 2, 7, -1, "bulk", None),
    ("batch.dispatched", 1.160, -1, 7, 1, "", {"attempts": 0}),
    ("chaos.kill", 1.170, -1, 7, 1, "", {"batch_index": 0, "duration_s": 0.0}),
    ("replica.evicted", 1.171, -1, -1, 1, "", {"reason": "chaos-kill", "orphans": 1}),
    ("batch.retry", 1.172, -1, 7, 1, "", {"attempts": 1, "reason": "chaos-kill"}),
    ("batch.dispatched", 1.173, -1, 7, 0, "", {"attempts": 1}),
    ("batch.cache_start", 1.180, -1, 7, 0, "", None),
    ("request.cache_lookup", 1.181, 1, 7, -1, "interactive", {"hit": False}),
    ("batch.cache_end", 1.185, -1, 7, 0, "", {"hits": 0}),
    ("batch.preprocess_start", 1.190, -1, 7, 0, "", None),
    ("batch.preprocess_end", 1.400, -1, 7, 0, "", None),
    ("batch.feature_start", 1.410, -1, 7, 0, "", None),
    ("batch.feature_end", 1.600, -1, 7, 0, "", None),
    ("request.completed", 1.650, 1, 7, -1, "interactive", None),
    ("request.completed", 1.660, 2, 7, -1, "bulk", None),
    ("batch.completed", 1.670, -1, 7, 0, "", None),
    ("cache.insert", 1.680, -1, -1, -1, "", {"bytes": 1024}),
    ("scale.rejoin", 1.700, -1, -1, 1, "", {"depth": 0, "reason": ""}),
    ("replica.rejoin", 1.701, -1, -1, 1, "", {"warm": True}),
    ("request.submit", 2.000, 6, -1, -1, "default", None),
    ("request.admitted", 2.001, 6, -1, -1, "default", None),
    ("request.drained", 2.010, 6, -1, -1, "default", None),
    ("batch.assembled", 2.020, -1, 8, -1, "default", {"members": [6], "bucket": 128}),
    ("request.assembled", 2.020, 6, 8, -1, "default", None),
    ("batch.dispatched", 2.021, -1, 8, 0, "", {"attempts": 0}),
    ("batch.execute_start", 2.030, -1, 8, 0, "", None),
    ("batch.execute_end", 2.130, -1, 8, 0, "", None),
    ("request.failed", 2.140, 6, 8, -1, "default", {"error": "RuntimeError"}),
    ("batch.failed", 2.141, -1, 8, 0, "", None),
    ("adapt.propose", 2.200, -1, -1, -1, "", {"kind": "buckets", "value": "(128, 256)"}),
    ("adapt.apply", 2.300, -1, -1, -1, "", {"kind": "buckets", "version": 1}),
)

# a malformed tail: a trace with no terminal, one with two, one whose time regresses
BROKEN = (
    ("request.submit", 3.0, 10, -1, -1, "default", None),
    ("request.drained", 3.1, 10, -1, -1, "default", None),
    ("request.submit", 3.2, 11, -1, -1, "default", None),
    ("request.completed", 3.3, 11, -1, -1, "default", None),
    ("request.failed", 3.4, 11, -1, -1, "default", None),
    ("request.submit", 3.5, 12, -1, -1, "default", None),
    ("request.drained", 3.45, 12, -1, -1, "default", None),
    ("request.expired", 3.6, 12, -1, -1, "default", None),
)


def _events(trace_mod, rows):
    return [trace_mod.TraceEvent(n, t, trace_id=tid, batch_id=bid, replica_id=rid, slo=slo,
                                 args=args) for n, t, tid, bid, rid, slo, args in rows]


def _plain(x):
    """A dataclass tree as plain tuples/dicts, so both packages' classes compare."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(_plain(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _records(metrics_mod):
    return (
        metrics_mod.BatchRecord(bucket=256, policy_key=("none", "auto", "pipelined", None),
                                n_real=2, batch_size=4, replica_id=0, duration_s=0.30,
                                batch_id=7),
        metrics_mod.BatchRecord(bucket=128, policy_key=("none", "auto", "sequential", None),
                                n_real=1, batch_size=4, replica_id=0, duration_s=0.11,
                                batch_id=8),
        metrics_mod.BatchRecord(bucket=128, policy_key=("none", "auto", "sequential", None),
                                n_real=0, batch_size=4, replica_id=1, duration_s=0.05),
    )


@pytest.mark.parametrize("rows", [STREAM, STREAM + BROKEN], ids=["well-formed", "broken"])
def test_reductions_equal_the_jax_package(rows):
    got, want = _events(t_trace, rows), _events(j_trace, rows)
    assert _plain(t_obs.request_timelines(got)) == _plain(j_obs.request_timelines(want))
    problems = t_obs.trace_problems(got)
    assert problems == j_obs.trace_problems(want)
    assert (problems != []) == (rows is not STREAM)
    t_bd, j_bd = t_obs.stage_breakdown(got), j_obs.stage_breakdown(want)
    assert t_bd.format_rows() == j_bd.format_rows()
    assert (t_bd.per_class, t_bd.counts) == (j_bd.per_class, j_bd.counts)
    checks = t_obs.batch_crosscheck(got, _records(t_metrics_mod))
    assert _plain(checks) == _plain(j_obs.batch_crosscheck(want, _records(j_metrics_mod)))
    assert [c.batch_id for c in checks] == [7, 8]


def test_the_stream_exercises_every_terminal():
    terminals = {r[0] for r in STREAM} & t_trace.TERMINAL_EVENTS
    assert terminals == set(t_trace.TERMINAL_EVENTS)


@pytest.mark.parametrize("rows", [STREAM, STREAM + BROKEN], ids=["well-formed", "broken"])
def test_chrome_trace_equals_the_jax_package(rows, tmp_path):
    got, want = _events(t_trace, rows), _events(j_trace, rows)
    assert json.dumps(t_obs.to_chrome_trace(got)) == json.dumps(j_obs.to_chrome_trace(want))
    n_t = t_obs.write_chrome_trace(tmp_path / "port.json", got)
    n_j = j_obs.write_chrome_trace(tmp_path / "jax.json", want)
    assert n_t == n_j
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


# batch 8's execute span holds one traced replay of the forward graph; the next
# replay's stage_times time it on the card; a capture outside any batch (warmup)
GRAPH = (
    ("graph.captured", 2.025, -1, -1, -1, "", {"stage": "forward", "shapes": [[4, 128, 3]],
                                               "seconds": 0.02}),
    ("graph.replay_end", 2.040, -1, 8, -1, "", {
        "stage": "forward", "start": 2.031, "found": 2.032, "copying": 2.0325, "copied": 2.034,
        "launched": 2.038, "cloned": 2.039, "bytes_in": 6144, "sources": ["pageable"]}),
    ("graph.stage_times", 2.131, -1, 8, -1, "", {
        "preprocess_ms": 2.5, "feature_ms": 20.0, "stage": "forward", "replay_t": 2.038}),
)


def test_graph_spans_render_inside_their_batch_and_on_the_device_lane():
    """The graph layer's events become its spans, slices on their batch's row
    inside the execute slice, and a device lane; the rest of the trace is as
    without them."""
    events = _events(t_trace, STREAM + GRAPH)
    spans = t_obs.graph_spans(events)
    assert [label for _, label, _, _ in spans] == [
        "graph replay (forward)", "graph lookup (forward)", "graph wait (forward)",
        "graph copy-in (forward)", "graph launch (forward)", "graph clone (forward)"]
    assert all(bid == 8 for bid, _, _, _ in spans)
    assert [t for _, _, t0, t1 in spans[1:] for t in (t0, t1)] == pytest.approx(
        [2.031, 2.032, 2.032, 2.0325, 2.0325, 2.034, 2.034, 2.038, 2.038, 2.039])
    assert t_obs.graph_stage_spans(events) == [
        (8, "preprocess", 2.038, 2.038 + 0.0025),
        (8, "feature", 2.038 + 0.0025, 2.038 + 0.0025 + 0.02)]
    doc = t_obs.to_chrome_trace(events)["traceEvents"]
    plain = t_obs.to_chrome_trace(_events(t_trace, STREAM))["traceEvents"]
    added = [e for e in doc if e not in plain]
    assert all(e in doc for e in plain)
    execute = next(e for e in plain if e.get("name") == "execute" and e["tid"] == 8)
    graph = [e for e in added if e["pid"] == 2]
    assert len(graph) == 7 and {e["tid"] for e in graph} == {0, 8}
    for e in graph:
        if e["tid"] == 8:
            assert execute["ts"] <= e["ts"] and e["ts"] + e["dur"] <= (
                execute["ts"] + execute["dur"] + 1e-6)
        else:
            assert e["name"] == "graph capture (forward)" and e["dur"] == pytest.approx(2e4)
    device = [e for e in added if e["pid"] == 4]
    assert device[0] == {"ph": "M", "pid": 4, "name": "process_name",
                         "args": {"name": "device"}}
    assert [(e["name"], e["tid"]) for e in device[1:]] == [("preprocess", 8), ("feature", 8)]
    assert len(added) == len(graph) + len(device)


def _replay(t, launch_ms, stage="forward"):
    """A graph.replay_end entered at t whose parts take 1, 0.5, 2, launch_ms and 1 ms."""
    start = t
    found, copying, copied = start + 1e-3, start + 1.5e-3, start + 3.5e-3
    launched = copied + launch_ms / 1e3
    return ("graph.replay_end", launched + 2e-3, -1, 1, -1, "", {
        "stage": stage, "start": start, "found": found, "copying": copying, "copied": copied,
        "launched": launched, "cloned": launched + 1e-3, "bytes_in": 8, "sources": ["pinned"]})


def test_graph_medians_reduce_each_stage_and_leave_out_a_stretch():
    """graph_medians: a median and a count of each part of one stage's replays
    and of each segment their stage times gave; replays that start in
    `outside`, and stage times of replays launched in it, are left out."""
    rows = (_replay(1.0, 1.0), _replay(1.1, 3.0), _replay(1.2, 2.0), _replay(1.3, 50.0),
            _replay(1.4, 9.0, stage="feature"),
            ("graph.stage_times", 1.5, -1, 1, -1, "", {
                "preprocess_ms": 0.5, "feature_ms": 4.0, "stage": "forward", "replay_t": 1.01}),
            ("graph.stage_times", 1.6, -1, 1, -1, "", {
                "preprocess_ms": 0.9, "feature_ms": 6.0, "stage": "forward", "replay_t": 1.31}))
    events = _events(t_trace, rows)
    whole = t_obs.graph_medians(events)
    assert list(whole) == ["replay", "lookup", "wait", "copy-in", "launch", "clone",
                           "card: preprocess", "card: feature"]
    assert whole["launch"] == pytest.approx((2.5, 4))
    assert whole["lookup"] == pytest.approx((1.0, 4)) and whole["wait"] == pytest.approx((0.5, 4))
    assert whole["copy-in"] == pytest.approx((2.0, 4))
    assert whole["replay"] == pytest.approx((3.5 + 2.5 + 2.0, 4))
    assert whole["card: feature"] == pytest.approx((5.0, 2))
    cut = t_obs.graph_medians(events, outside=(1.25, 1.35))
    assert cut["launch"] == pytest.approx((2.0, 3)) and cut["card: preprocess"] == (0.5, 1)
    assert t_obs.graph_medians(events, "feature")["launch"] == pytest.approx((9.0, 1))
    assert t_obs.graph_medians(events, "preprocess") == {}
    assert t_obs.graph_medians(_events(t_trace, STREAM)) == {}


class _Clock:
    """A scripted time.monotonic: each call advances by `step` seconds."""

    def __init__(self, t0=100.0, step=0.0625):
        self.t, self.step = t0, step

    def monotonic(self):
        self.t += self.step
        return self.t

    sleep = staticmethod(time.sleep)


def _feed(metrics_mod):
    """The same sequence of records into one package's ServeMetrics."""
    m = metrics_mod.ServeMetrics()
    for i in range(12):
        slo = ("interactive", "bulk", None)[i % 3]
        m.record_submitted(slo)
        m.record_arrival(100 + 37 * i, slo)
        m.record_queue_hwm(i % 5, slo, i % 7)
        m.record_inflight(i % 3)
    for i in range(9):
        m.record_completed(0.001 * (i + 1) ** 1.5, ("interactive", "bulk", None)[i % 3])
    m.record_rejected("bulk")
    m.record_shed("bulk")
    m.record_expired(None)
    m.record_failed(2)
    m.record_retry()
    m.record_eviction()
    m.record_rejoin()
    m.record_straggler(None, replica_id=1)
    m.record_straggler(None, replica_id=0)
    m.record_straggler(None, replica_id=1)
    m.record_cache_lookup(True, 3)
    m.record_cache_lookup(False, 5)
    m.record_queue_depth(4)
    for rec in _records(metrics_mod):
        m.record_batch(rec)
    m.record_batch(metrics_mod.BatchRecord(
        bucket=256, policy_key=(), n_real=3, batch_size=4, replica_id=1, duration_s=0.02,
        preprocess_skipped=True, batch_id=9))
    return m


def test_prometheus_text_equals_the_jax_package(monkeypatch):
    monkeypatch.setattr(t_metrics_mod, "time", _Clock())
    monkeypatch.setattr(j_metrics_mod, "time", _Clock())
    t_snap, j_snap = _feed(t_metrics_mod).snapshot(), _feed(j_metrics_mod).snapshot()
    assert _plain(t_snap) == _plain(j_snap)
    text = t_obs.prometheus_text(t_snap)
    assert text == j_obs.prometheus_text(j_snap)
    assert "pc2im_serve_completed_total 9" in text
    assert 'pc2im_serve_stragglers_total{replica="1"} 2' in text
    assert 'pc2im_serve_class_shed_total{slo="bulk"} 1' in text
    # an empty snapshot too: no per-class and no straggler families
    assert t_obs.prometheus_text(ServeMetrics().snapshot()) == j_obs.prometheus_text(
        j_metrics_mod.ServeMetrics().snapshot())


def test_reporter_line_equals_the_jax_package(monkeypatch):
    monkeypatch.setattr(t_metrics_mod, "time", _Clock())
    monkeypatch.setattr(j_metrics_mod, "time", _Clock())
    lines_t, lines_j = [], []
    t_rep = Reporter(_feed(t_metrics_mod), 10.0, sink=lines_t.append, tracer=Tracer())
    j_rep = j_obs.Reporter(_feed(j_metrics_mod), 10.0, sink=lines_j.append,
                           tracer=j_trace.Tracer())
    assert t_rep.report_once() == j_rep.report_once()
    assert lines_t == lines_j and lines_t[0].startswith("[serve] completed=9")
    assert t_rep.last_snapshot.completed == 9 and t_rep.ticks == 1
    with pytest.raises(ValueError, match="interval_s"):
        Reporter(ServeMetrics(), 0.0)


def test_reporter_thread_ticks_and_final_report(capsys):
    rep = Reporter(ServeMetrics(), 3600.0).start()
    try:
        rep.report_once()
    finally:
        rep.stop()  # the final tick
    assert rep.ticks == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and all(line.startswith("[serve] completed=0") for line in err)


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def test_metrics_server_scrape_and_health():
    metrics = ServeMetrics()
    metrics.record_submitted()
    metrics.record_completed(0.01)
    server = MetricsServer(metrics, port=0).start()
    try:
        assert server.port != 0 and server.url.startswith("http://127.0.0.1:")
        status, body = _get(server.url + "/metrics")
        assert status == 200
        assert body == t_obs.prometheus_text(metrics.snapshot())
        assert "pc2im_serve_completed_total 1" in body
        status, body = _get(server.url + "/healthz")
        assert status == 200 and body == "ok\n"
        with pytest.raises(urllib.error.HTTPError):
            _get(server.url + "/nope")
    finally:
        server.stop()
    with pytest.raises(OSError):
        _get(server.url + "/healthz", timeout=1.0)
    server.stop()  # idempotent


@pytest.fixture(scope="module")
def cfg():
    return get_config("pointnet2-cls", smoke=True)  # n_points=256


@pytest.fixture(scope="module")
def params(cfg):
    return get_accelerator(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def _clouds(k, seed, sizes=(256, 150, 300)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((sizes[i % len(sizes)], 3)).astype(np.float32)
            for i in range(k)]


def test_runtime_lifecycle_owns_the_listener_and_reporter(cfg, params):
    rt = ServingRuntime(cfg, params, RuntimeConfig(max_batch=MAX_BATCH, buckets=(256,),
                                                   prometheus_port=0,
                                                   report_interval_s=3600.0),
                        device="cpu")
    try:
        assert isinstance(rt.metrics_server, MetricsServer)
        assert isinstance(rt.reporter, Reporter)
        rt.start()
        assert rt.metrics_server.port != 0
        rt.submit(_clouds(1, seed=1)[0]).result(timeout=WAIT_S)
        _, body = _get(rt.metrics_server.url + "/metrics")
        assert "pc2im_serve_submitted_total 1" in body
        assert _get(rt.metrics_server.url + "/healthz") == (200, "ok\n")
    finally:
        rt.stop()
    with pytest.raises(OSError):
        _get(rt.metrics_server.url + "/healthz", timeout=1.0)
    assert rt.reporter.last_snapshot is not None and rt.reporter.last_snapshot.completed == 1


def test_traced_cpu_runtime_is_well_formed(cfg, params):
    """A traced CPU runtime: no trace problems, one timeline per request, every
    real batch reconciled against its record, each response bitwise equal to the
    port's infer of the padded batch the trace says it rode in."""
    clouds = _clouds(10, seed=2)
    rt = ServingRuntime(cfg, params, RuntimeConfig(max_batch=MAX_BATCH, buckets=(128, 256),
                                                   trace=TraceConfig()), device="cpu")
    try:
        rt.warmup()
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        deadline = time.monotonic() + WAIT_S
        while sum(b.n_real for b in rt.metrics.batch_records) < len(clouds):
            assert time.monotonic() < deadline
            time.sleep(0.001)
    finally:
        rt.stop()
    events = rt.tracer.events()
    assert trace_problems(events) == []
    timelines = t_obs.request_timelines(events)
    assert len(timelines) == len(clouds) and all(tl.completed for tl in timelines.values())
    real = [b for b in rt.metrics.batch_records if b.n_real]
    checks = batch_crosscheck(events, rt.metrics.batch_records)
    assert sorted(c.batch_id for c in checks) == sorted(b.batch_id for b in real)
    order = {e.trace_id: k for k, e in enumerate(e for e in events if e.name == "request.submit")}
    accel = get_accelerator(cfg, device="cpu")
    seen = 0
    for e in events:
        if e.name != "batch.assembled":
            continue
        idx = [order[t] for t in e.args["members"]]
        bucket = e.args["bucket"]
        reqs = [Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0], bucket=bucket,
                        policy=resolve_policy(cfg, None), deadline_t=None, submit_t=0.0,
                        future=None) for i in idx]
        want = accel.infer(params, assemble_batch(reqs, bucket, 3, MAX_BATCH)).numpy()
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(outs[i], want[j])
            seen += 1
    assert seen == len(clouds)
    assert isinstance(rt.metrics.batch_records[0], BatchRecord)


def test_obs_names_equal_the_jax_package():
    assert t_obs.STAGES == j_obs.STAGES
    public = {n for n in dir(j_obs) if not n.startswith("_")} - {
        "annotations", "dataclasses", "json", "sys", "threading", "np"}
    assert public <= set(dir(t_obs)), sorted(public - set(dir(t_obs)))



def test_served_batches_reads_members_in_submit_order():
    """Members come back as submit-order indices, whatever their trace ids, in
    assembly order, each with its bucket; warmup batches carry no event."""
    E = t_trace.TraceEvent
    events = [E("request.submit", 1.0, trace_id=7), E("request.submit", 1.1, trace_id=3),
              E("request.submit", 1.2, trace_id=9),
              E("batch.assembled", 1.3, batch_id=1, args={"members": [3, 9], "bucket": 256}),
              E("request.completed", 1.4, trace_id=3),
              E("batch.assembled", 1.5, batch_id=2, args={"members": [7], "bucket": 128})]
    assert t_obs.served_batches(events) == [([1, 2], 256), ([0], 128)]
    assert t_obs.served_batches([]) == []


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
def test_padded_batch_responses_equal_infer_of_the_padded_batch(model):
    """Each member's response is its row of `infer` of assemble_batch's padded
    batch (seg: padded rows dropped, a subsampled cloud's points mapped to
    their kept rows), under its own quant; a batch whose members' quants
    differ raises."""
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.serve import inverse_subsample_indices

    cfg = get_config(model, smoke=True)
    params = get_accelerator(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    clouds = _clouds(5, seed=3)
    sc = ExecutionPolicy(quant="sc_w16a16")
    policies = [None, None, sc, sc, sc]
    batches = [([1, 0], 256), ([4, 2, 3], 256)]
    got = t_obs.padded_batch_responses(cfg, params, clouds, policies, batches, MAX_BATCH)
    assert sorted(got) == list(range(len(clouds)))
    for idx, bucket in batches:
        pol = resolve_policy(cfg, policies[idx[0]])
        reqs = [Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0], bucket=bucket,
                        policy=pol, deadline_t=None, submit_t=0.0, future=None) for i in idx]
        want = get_accelerator(cfg, pol, device="cpu").infer(
            params, assemble_batch(reqs, bucket, 3 + cfg.in_features, MAX_BATCH)).numpy()
        for j, i in enumerate(idx):
            n = clouds[i].shape[0]
            row = want[j] if cfg.task != "seg" else (
                want[j, :n] if n <= bucket else want[j, inverse_subsample_indices(n, bucket)])
            np.testing.assert_array_equal(got[i], row)
    with pytest.raises(ValueError, match="mixed quants"):
        t_obs.padded_batch_responses(cfg, params, clouds, policies, [([1, 2], 256)], MAX_BATCH)
