"""Reductions and exporters over the serving trace stream.

serve/trace.py records *edges*; this module turns them into answers.  The
reductions are pure functions over a ``list[TraceEvent]`` snapshot (grab one
with ``tracer.events()``) so they can run offline, in tests, or inside the
periodic :class:`Reporter` without touching the hot path:

* :func:`request_timelines` — group the stream per trace id into
  :class:`RequestTimeline` records: the ordered span, its terminal outcome,
  end-to-end latency, and a per-stage attribution (queue wait, assembly,
  dispatch, cache, preprocess, splice, feature, execute, finalize) derived
  purely from event timestamps.  The stage edges telescope, so their sum
  approaches the measured e2e latency; the gap is reported as ``residual_s``.
* :func:`trace_problems` — structural lint: every trace must carry exactly
  one terminal event and per-trace timestamps must be monotonic.
* :func:`served_batches` / :func:`padded_batch_responses` — which requests
  rode in each micro-batch, and the response each gets from an eager
  ``infer`` of that padded batch: the runtime's contract, which a served
  response is held to bitwise.
* :func:`stage_breakdown` — per-SLO-class p50/p95 of each stage over the
  completed timelines (the operator-facing "where does my latency go").
* :func:`batch_crosscheck` — reconcile batch spans against the
  independently-timed ``BatchRecord.duration_s`` wall-clock, keyed by the
  ``batch_id`` both sides carry.
* :func:`graph_spans` / :func:`graph_stage_spans` — the graph layer's
  spans (core/graphs.py inside ``graphs.traced``): each replay and its
  lookup, wait, copy-in, launch and clone on the host, and the card's time of
  each stage a traced capture marked; :func:`graph_medians` reduces them
  to a median a part and a stage.
* :func:`to_chrome_trace` / :func:`write_chrome_trace` — Chrome-trace /
  Perfetto JSON: request lanes, batch lanes with stage slices and the
  graph replays nested in them, a device lane of graph stage times where
  there are any, and a control-plane lane, all on one shared clock.
* :func:`prometheus_text` — Prometheus text exposition of a
  :class:`~repro_torch.serve.metrics.MetricsSnapshot`.

Two stateful exporters live at the end: :class:`Reporter`, a daemon thread
on :class:`~repro_torch.serve.runtime.ServingRuntime` that periodically snapshots
the metrics and hands a one-line summary to a sink, and
:class:`MetricsServer`, an opt-in stdlib HTTP listener serving the live
:func:`prometheus_text` exposition at ``GET /metrics`` (plus ``/healthz``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading

import numpy as np

from repro_torch.core import graphs
from repro_torch.core.accelerator import get_accelerator, params_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.serve.metrics import BatchRecord, MetricsSnapshot
from repro_torch.serve.queue import Request
from repro_torch.serve.scheduler import MicroBatch, assemble_batch, scatter_results
from repro_torch.serve.trace import TERMINAL_EVENTS, TraceEvent

#: Stage names of the per-request attribution, in pipeline order.  Edge
#: definitions live in `_stages_for`; every stage is the time between two
#: recorded trace edges, so the stages of one request telescope from submit
#: to terminal (micro-gaps between edges surface as `residual_s`).
STAGES: tuple[str, ...] = (
    "queue",  # request.submit -> request.drained (admission-lane wait)
    "assembly",  # request.drained -> request.assembled (batch formation)
    "dispatch",  # request.assembled -> first execution edge of the batch
    "cache",  # batch.cache_start -> batch.cache_end (probe + restack)
    "preprocess",  # batch.preprocess_start -> batch.preprocess_end
    "splice",  # batch.splice_start -> batch.splice_end (hit-row merge)
    "feature",  # batch.feature_start -> batch.feature_end
    "execute",  # batch.execute_start -> batch.execute_end (fused path)
    "finalize",  # last execution edge -> request terminal (result scatter)
)

_PAIRED = ("cache", "preprocess", "splice", "feature", "execute")


@dataclasses.dataclass(frozen=True)
class RequestTimeline:
    """One request's reconstructed span: ordered events + stage attribution.

    ``events`` is the trace-id's slice of the stream in emission order;
    ``terminal`` is the span's terminal event name (None if the trace was
    truncated by ring overflow); ``e2e_s`` is terminal minus submit.
    ``stages`` maps stage name -> seconds for the stages this request
    actually passed through, and ``residual_s`` is ``e2e_s`` minus their sum
    — the unattributed micro-gaps between recorded edges (close to zero for
    a well-formed sequential trace).
    """

    trace_id: int
    slo: str
    events: tuple[TraceEvent, ...]
    terminal: str | None
    e2e_s: float | None
    batch_id: int
    stages: dict[str, float]
    residual_s: float | None

    @property
    def completed(self) -> bool:
        """True when the span terminated in ``request.completed``."""
        return self.terminal == "request.completed"


def _first(events, name) -> TraceEvent | None:
    """The first event named `name`, or None."""
    for ev in events:
        if ev.name == name:
            return ev
    return None


def _stage_pairs(batch_events: list[TraceEvent]) -> dict[str, tuple[float, float]]:
    """Pair each `batch.<stage>_start` with its next `_end`, keeping the last.

    A retried batch executes its stages more than once; the last complete
    pair is the attempt whose results the requests actually received.
    """
    pairs: dict[str, tuple[float, float]] = {}
    open_t: dict[str, float] = {}
    for ev in batch_events:
        scope, _, edge = ev.name.partition(".")
        if scope != "batch":
            continue
        stage, sep, side = edge.rpartition("_")
        if not sep or stage not in _PAIRED:
            continue
        if side == "start":
            open_t[stage] = ev.t
        elif side == "end" and stage in open_t:
            pairs[stage] = (open_t.pop(stage), ev.t)
    return pairs


def _stages_for(
    req_events: list[TraceEvent],
    batch_events: list[TraceEvent],
    terminal: TraceEvent | None,
) -> dict[str, float]:
    """Per-stage seconds for one request, from its own + its batch's edges."""
    stages: dict[str, float] = {}
    submit = _first(req_events, "request.submit")
    drained = _first(req_events, "request.drained")
    assembled = _first(req_events, "request.assembled")
    if submit is not None and drained is not None:
        stages["queue"] = max(0.0, drained.t - submit.t)
    if drained is not None and assembled is not None:
        stages["assembly"] = max(0.0, assembled.t - drained.t)
    pairs = _stage_pairs(batch_events)
    if pairs:
        first_start = min(t0 for t0, _ in pairs.values())
        last_end = max(t1 for _, t1 in pairs.values())
        if assembled is not None:
            stages["dispatch"] = max(0.0, first_start - assembled.t)
        for stage, (t0, t1) in pairs.items():
            stages[stage] = max(0.0, t1 - t0)
        if terminal is not None:
            stages["finalize"] = max(0.0, terminal.t - last_end)
    return stages


def request_timelines(events: list[TraceEvent]) -> dict[int, RequestTimeline]:
    """Group a trace-stream snapshot into per-request timelines.

    Returns trace id -> :class:`RequestTimeline`, covering every trace id
    that appears in `events`.  Batch-level stage edges are joined to member
    requests through the ``batch_id`` their ``request.assembled`` /
    ``request.completed`` events carry.
    """
    by_trace: dict[int, list[TraceEvent]] = {}
    by_batch: dict[int, list[TraceEvent]] = {}
    for ev in events:
        if ev.trace_id != -1:
            by_trace.setdefault(ev.trace_id, []).append(ev)
        elif ev.batch_id != -1 and ev.name.startswith("batch."):
            by_batch.setdefault(ev.batch_id, []).append(ev)
    out: dict[int, RequestTimeline] = {}
    for tid, revs in by_trace.items():
        terminal = next((e for e in revs if e.name in TERMINAL_EVENTS), None)
        submit = _first(revs, "request.submit")
        batch_id = next((e.batch_id for e in revs if e.batch_id != -1), -1)
        e2e = (
            terminal.t - submit.t
            if terminal is not None and submit is not None
            else None
        )
        stages = _stages_for(revs, by_batch.get(batch_id, []), terminal)
        residual = e2e - sum(stages.values()) if e2e is not None else None
        slo = next((e.slo for e in revs if e.slo), "default")
        out[tid] = RequestTimeline(
            trace_id=tid,
            slo=slo,
            events=tuple(revs),
            terminal=terminal.name if terminal is not None else None,
            e2e_s=e2e,
            batch_id=batch_id,
            stages=stages,
            residual_s=residual,
        )
    return out


def trace_problems(events: list[TraceEvent]) -> list[str]:
    """Structural lint of a trace snapshot; empty list means well-formed.

    Flags traces with zero or multiple terminal events and traces whose
    timestamps regress in emission order (the lifecycle edges of one request
    are causally ordered, so per-trace time must be monotonic).  Traces
    whose ``request.submit`` fell off the ring are skipped — a truncated
    head is a capacity artifact, not a protocol violation.
    """
    problems: list[str] = []
    by_trace: dict[int, list[TraceEvent]] = {}
    for ev in events:
        if ev.trace_id != -1:
            by_trace.setdefault(ev.trace_id, []).append(ev)
    for tid, revs in sorted(by_trace.items()):
        if _first(revs, "request.submit") is None:
            continue  # head truncated by ring overflow
        terminals = [e.name for e in revs if e.name in TERMINAL_EVENTS]
        if not terminals:
            problems.append(f"trace {tid}: no terminal event")
        elif len(terminals) > 1:
            problems.append(f"trace {tid}: multiple terminals {terminals}")
        for a, b in zip(revs, revs[1:]):
            if b.t < a.t:
                problems.append(
                    f"trace {tid}: time regressed {a.name}@{a.t:.6f} -> "
                    f"{b.name}@{b.t:.6f}"
                )
                break
    return problems


def served_batches(events: list[TraceEvent]) -> list[tuple[list[int], int]]:
    """(members, bucket) of every real micro-batch in a trace snapshot.

    In assembly order.  ``batch.assembled`` lists its members' trace ids,
    which come back as indices in ``request.submit`` order: the order the
    caller submitted in, where it submitted from one thread.
    """
    order = {e.trace_id: k
             for k, e in enumerate(e for e in events if e.name == "request.submit")}
    return [([order[t] for t in e.args["members"]], e.args["bucket"])
            for e in events if e.name == "batch.assembled"]


def padded_batch_responses(cfg, params, clouds, policies, batches,
                           max_batch: int) -> dict[int, np.ndarray]:
    """Each served cloud's response from an eager ``infer`` of its padded batch.

    `batches` is :func:`served_batches`' (members, bucket) list, and
    `policies` gives each cloud's policy (an ExecutionPolicy, or None for
    the config's default).  The batch is `assemble_batch`'s at its bucket
    and `max_batch` rows, run under ``graphs.eager()`` on the device
    `params` lie on, single-device under its members' quant (a sharded or
    pipelined request is held to that answer), and split as the scheduler
    splits it (`scatter_results`: a seg response keeps a row a point).
    Raises ValueError for a batch whose members' quants differ, which the
    scheduler never assembles.
    """
    device = params_device(params)
    out: dict[int, np.ndarray] = {}
    for idx, bucket in batches:
        quants = {resolve_policy(cfg, policies[i]).quant for i in idx}
        if len(quants) != 1:
            raise ValueError(f"a served batch mixed quants {sorted(quants)}")
        accel = get_accelerator(cfg, ExecutionPolicy(quant=quants.pop()), device=device)
        reqs = tuple(Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0], bucket=bucket,
                             policy=accel.policy, deadline_t=None, submit_t=0.0, future=None)
                     for i in idx)
        mb = MicroBatch(requests=reqs, bucket=bucket, policy=accel.policy,
                        batch=assemble_batch(reqs, bucket, 3 + cfg.in_features, max_batch))
        with graphs.eager():
            logits = accel.infer(params, mb.batch).cpu().numpy()
        out.update(zip(idx, scatter_results(cfg.task, logits, mb)))
    return out


@dataclasses.dataclass(frozen=True)
class StageBreakdown:
    """Per-SLO-class latency attribution reduced from completed timelines.

    ``per_class`` maps SLO class name -> stage name -> (p50_s, p95_s) over
    the completed requests of that class; ``counts`` maps class name -> how
    many completed timelines the percentiles were computed from.
    """

    per_class: dict[str, dict[str, tuple[float, float]]]
    counts: dict[str, int]

    def format_rows(self) -> str:
        """Human-readable table: one line per (class, stage) with p50/p95."""
        lines = []
        for slo in sorted(self.per_class):
            lines.append(f"[{slo}] n={self.counts[slo]}")
            for stage in STAGES:
                if stage not in self.per_class[slo]:
                    continue
                p50, p95 = self.per_class[slo][stage]
                lines.append(
                    f"  {stage:<10} p50={p50 * 1e3:8.3f}ms p95={p95 * 1e3:8.3f}ms"
                )
        return "\n".join(lines)


def stage_breakdown(events: list[TraceEvent]) -> StageBreakdown:
    """Reduce a trace snapshot to per-SLO-class stage percentiles.

    Only completed requests contribute — shed/rejected/expired spans never
    reached the stages being attributed.  Stages a class never passed
    through (e.g. ``splice`` without a cache) are absent from its map.
    """
    samples: dict[str, dict[str, list[float]]] = {}
    counts: dict[str, int] = {}
    for tl in request_timelines(events).values():
        if not tl.completed:
            continue
        counts[tl.slo] = counts.get(tl.slo, 0) + 1
        per = samples.setdefault(tl.slo, {})
        for stage, dur in tl.stages.items():
            per.setdefault(stage, []).append(dur)
    per_class = {
        slo: {
            stage: (
                float(np.percentile(vals, 50)),
                float(np.percentile(vals, 95)),
            )
            for stage, vals in stages.items()
        }
        for slo, stages in samples.items()
    }
    return StageBreakdown(per_class=per_class, counts=counts)


@dataclasses.dataclass(frozen=True)
class BatchCheck:
    """One batch's span-vs-record reconciliation (see `batch_crosscheck`).

    ``span_s`` is last execution edge minus first (the trace's view of the
    batch's on-replica time); ``stage_sum_s`` sums the individual stage
    pairs; ``recorded_s`` is the dispatch layer's independently-timed
    ``BatchRecord.duration_s``; ``rel_err`` is |span - recorded| / recorded.
    """

    batch_id: int
    span_s: float
    stage_sum_s: float
    recorded_s: float
    rel_err: float


def batch_crosscheck(
    events: list[TraceEvent], records: tuple[BatchRecord, ...]
) -> list[BatchCheck]:
    """Reconcile trace batch spans against BatchRecord wall-clock timings.

    Joins on the ``batch_id`` both sides carry and returns one
    :class:`BatchCheck` per batch that has BOTH a complete trace span and a
    record.  The two clocks are independent code paths over the same work,
    so a large ``rel_err`` means the instrumentation edges drifted from
    what the dispatch timer actually brackets.  Sequential batches should
    reconcile tightly; pipelined records time only the feature-thread
    portion (splice+feature), so compare against ``stage_sum_s`` there.
    """
    by_batch: dict[int, list[TraceEvent]] = {}
    for ev in events:
        if ev.batch_id != -1 and ev.name.startswith("batch."):
            by_batch.setdefault(ev.batch_id, []).append(ev)
    out: list[BatchCheck] = []
    for rec in records:
        if rec.batch_id == -1:
            continue
        pairs = _stage_pairs(by_batch.get(rec.batch_id, []))
        if not pairs or rec.duration_s <= 0:
            continue
        span = max(t1 for _, t1 in pairs.values()) - min(
            t0 for t0, _ in pairs.values()
        )
        stage_sum = sum(t1 - t0 for t0, t1 in pairs.values())
        out.append(
            BatchCheck(
                batch_id=rec.batch_id,
                span_s=span,
                stage_sum_s=stage_sum,
                recorded_s=rec.duration_s,
                rel_err=abs(span - rec.duration_s) / rec.duration_s,
            )
        )
    return out


# -- the graph layer's spans ----------------------------------------------------

#: The parts of one traced graph replay, in order: (label, the args key of
#: its start, of its end) in ``graph.replay_end``.
GRAPH_PARTS: tuple[tuple[str, str, str], ...] = (
    ("lookup", "start", "found"),
    ("wait", "found", "copying"),  # the artifact's lock, another stream, the last stage times
    ("copy-in", "copying", "copied"),
    ("launch", "copied", "launched"),
    ("clone", "launched", "cloned"),
)


def graph_spans(events: list[TraceEvent]) -> list[tuple[int, str, float, float]]:
    """(batch_id, label, t0, t1) of every traced graph replay and of its parts.

    Each ``graph.replay_end`` gives "graph replay (<stage>)", from the
    call's entry to the event, then one span per :data:`GRAPH_PARTS` entry,
    "graph <part> (<stage>)".  Times are ``time.monotonic`` seconds.
    """
    out = []
    for ev in events:
        if ev.name != "graph.replay_end":
            continue
        a = ev.args
        out.append((ev.batch_id, f"graph replay ({a['stage']})", a["start"], ev.t))
        out.extend((ev.batch_id, f"graph {part} ({a['stage']})", a[t0], a[t1])
                   for part, t0, t1 in GRAPH_PARTS)
    return out


def graph_stage_spans(events: list[TraceEvent]) -> list[tuple[int, str, float, float]]:
    """(batch_id, segment, t0, t1) of every segment a ``graph.stage_times`` event timed.

    The durations are the card's own (timing events in the graph); the
    segments are laid end to end from the host's launch of the replay they
    timed, which the card starts on no earlier.
    """
    out = []
    for ev in events:
        if ev.name != "graph.stage_times":
            continue
        t = ev.args["replay_t"]
        for key, ms in ev.args.items():
            if key.endswith("_ms"):
                out.append((ev.batch_id, key[:-3], t, t + ms / 1e3))
                t += ms / 1e3
    return out


def graph_medians(events: list[TraceEvent], stage: str = "forward",
                  outside: tuple[float, float] | None = None) -> dict[str, tuple[float, int]]:
    """{label: (median ms, count)} over the traced replays of ``stage``.

    The labels: "replay" (the call's entry to ``graph.replay_end``), each
    part of :data:`GRAPH_PARTS`, and "card: <segment>" for each segment
    the replays' ``graph.stage_times`` timed.  ``outside`` = (t0, t1), in
    ``time.monotonic`` seconds, leaves out the replays that started in it
    and the stage times of the replays launched in it: a profiled stretch,
    under which both read longer.
    """
    def kept(t):
        return outside is None or not outside[0] <= t <= outside[1]

    parts: dict[str, list[float]] = {}
    for ev in events:
        a = ev.args or {}
        if a.get("stage") != stage:
            continue
        if ev.name == "graph.replay_end" and kept(a["start"]):
            parts.setdefault("replay", []).append((ev.t - a["start"]) * 1e3)
            for part, t0, t1 in GRAPH_PARTS:
                parts.setdefault(part, []).append((a[t1] - a[t0]) * 1e3)
        elif ev.name == "graph.stage_times" and kept(a["replay_t"]):
            for key, ms in a.items():
                if key.endswith("_ms"):
                    parts.setdefault(f"card: {key[:-3]}", []).append(ms)
    return {label: (float(np.median(ms)), len(ms)) for label, ms in parts.items()}


# -- Chrome trace / Perfetto export -------------------------------------------

_PID_REQUESTS = 1
_PID_BATCHES = 2
_PID_CONTROL = 3
_PID_DEVICE = 4


def to_chrome_trace(events: list[TraceEvent]) -> dict:
    """Render a trace snapshot as a Chrome-trace (Perfetto-loadable) object.

    Three process lanes share one clock: ``requests`` (one thread row per
    trace id — a complete "X" slice from submit to terminal plus instant
    marks for every edge), ``batches`` (one row per batch id — "X" slices
    per execution stage plus assembly/dispatch/retry instants) and
    ``control-plane`` (one row per replica — eviction/rejoin/scale/chaos/
    cache instants).  Traced graph replays (:func:`graph_spans`) and
    captures are "X" slices on their batch's row, inside its execute or
    stage slice (row 0 for those outside a served batch), and the card's
    stage times (:func:`graph_stage_spans`) fill a fourth lane, ``device``,
    one row per batch.  Timestamps are microseconds of ``time.monotonic``;
    load the JSON in https://ui.perfetto.dev or chrome://tracing.
    """
    out: list[dict] = [
        {
            "ph": "M",
            "pid": pid,
            "name": "process_name",
            "args": {"name": label},
        }
        for pid, label in (
            (_PID_REQUESTS, "requests"),
            (_PID_BATCHES, "batches"),
            (_PID_CONTROL, "control-plane"),
        )
    ]
    timelines = request_timelines(events)
    for tl in timelines.values():
        submit = _first(list(tl.events), "request.submit")
        if submit is not None and tl.e2e_s is not None:
            out.append(
                {
                    "ph": "X",
                    "pid": _PID_REQUESTS,
                    "tid": tl.trace_id,
                    "name": f"{tl.terminal} [{tl.slo}]",
                    "ts": submit.t * 1e6,
                    "dur": tl.e2e_s * 1e6,
                    "args": {"batch_id": tl.batch_id, **tl.stages},
                }
            )
        for ev in tl.events:
            out.append(
                {
                    "ph": "i",
                    "pid": _PID_REQUESTS,
                    "tid": tl.trace_id,
                    "name": ev.name,
                    "ts": ev.t * 1e6,
                    "s": "t",
                    "args": ev.args or {},
                }
            )
    by_batch: dict[int, list[TraceEvent]] = {}
    for ev in events:
        if ev.name.startswith("batch.") and ev.batch_id != -1:
            by_batch.setdefault(ev.batch_id, []).append(ev)
    for bid, bevs in by_batch.items():
        for stage, (t0, t1) in _stage_pairs(bevs).items():
            out.append(
                {
                    "ph": "X",
                    "pid": _PID_BATCHES,
                    "tid": bid,
                    "name": stage,
                    "ts": t0 * 1e6,
                    "dur": (t1 - t0) * 1e6,
                }
            )
        for ev in bevs:
            if ev.name.endswith(("_start", "_end")):
                continue  # already rendered as an "X" slice above
            out.append(
                {
                    "ph": "i",
                    "pid": _PID_BATCHES,
                    "tid": bid,
                    "name": ev.name,
                    "ts": ev.t * 1e6,
                    "s": "t",
                    "args": ev.args or {},
                }
            )
    for bid, label, t0, t1 in graph_spans(events):
        out.append({"ph": "X", "pid": _PID_BATCHES, "tid": max(0, bid), "name": label,
                    "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6})
    for ev in events:
        if ev.name == "graph.captured":
            secs = ev.args["seconds"]
            out.append({"ph": "X", "pid": _PID_BATCHES, "tid": max(0, ev.batch_id),
                        "name": f"graph capture ({ev.args['stage']})",
                        "ts": (ev.t - secs) * 1e6, "dur": secs * 1e6, "args": ev.args})
    stages = graph_stage_spans(events)
    if stages:
        out.append({"ph": "M", "pid": _PID_DEVICE, "name": "process_name",
                    "args": {"name": "device"}})
    for bid, segment, t0, t1 in stages:
        out.append({"ph": "X", "pid": _PID_DEVICE, "tid": max(0, bid), "name": segment,
                    "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6})
    for ev in events:
        scope = ev.name.partition(".")[0]
        if scope in ("request", "batch", "graph"):
            continue
        out.append(
            {
                "ph": "i",
                "pid": _PID_CONTROL,
                "tid": max(0, ev.replica_id),
                "name": ev.name,
                "ts": ev.t * 1e6,
                "s": "p",
                "args": ev.args or {},
            }
        )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path, events: list[TraceEvent]) -> int:
    """Write `to_chrome_trace(events)` as JSON at `path`; returns event count."""
    doc = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


# -- Prometheus text exposition -----------------------------------------------


def _prom(lines, name, kind, help_text, samples):
    """Append one metric family (# HELP/# TYPE + samples) to `lines`."""
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {kind}")
    for labels, value in samples:
        label_s = (
            "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
            if labels
            else ""
        )
        lines.append(f"{name}{label_s} {value}")


def prometheus_text(snap: MetricsSnapshot) -> str:
    """Render one MetricsSnapshot in the Prometheus text exposition format.

    Counters become ``pc2im_serve_*_total`` (with a ``slo`` label for the
    per-class breakdown and a ``replica`` label for straggler attribution);
    latency percentiles, throughput, occupancy and the high-water-mark
    gauges come out as gauges.  The string ends with a newline as the
    format requires; scrape adapters can serve it verbatim.
    """
    lines: list[str] = []
    for field, help_text in (
        ("submitted", "Requests admitted"),
        ("completed", "Requests completed"),
        ("rejected", "Requests refused at admission"),
        ("expired", "Requests failed on deadline"),
        ("failed", "Requests failed by execution errors"),
        ("shed", "Requests load-shed"),
        ("retries", "Batch re-dispatches after replica failure"),
        ("evictions", "Replicas evicted"),
        ("rejoins", "Replicas re-admitted"),
        ("batches", "Executed micro-batches with real traffic"),
        ("straggler_events", "Slow-but-alive replica batches"),
        ("cache_hits", "Preprocess-cache lookup hits"),
        ("cache_misses", "Preprocess-cache lookup misses"),
        ("preprocess_skipped", "All-hit batches that skipped preprocess"),
    ):
        _prom(
            lines,
            f"pc2im_serve_{field}_total",
            "counter",
            help_text,
            [({}, getattr(snap, field))],
        )
    _prom(
        lines,
        "pc2im_serve_latency_seconds",
        "gauge",
        "End-to-end latency percentiles",
        [
            ({"quantile": "0.5"}, snap.latency_p50_s),
            ({"quantile": "0.95"}, snap.latency_p95_s),
            ({"quantile": "0.99"}, snap.latency_p99_s),
        ],
    )
    for field, help_text in (
        ("throughput_rps", "Completed requests per second"),
        ("mean_occupancy", "Mean real-request fill of executed batches"),
        ("queue_depth_hwm", "Max total queue depth ever observed"),
        ("inflight_hwm", "Max concurrently-inflight micro-batches"),
        ("cache_saved_s", "Estimated batch seconds saved by cache skips"),
    ):
        _prom(
            lines,
            f"pc2im_serve_{field}",
            "gauge",
            help_text,
            [({}, getattr(snap, field))],
        )
    if snap.stragglers_by_replica:
        _prom(
            lines,
            "pc2im_serve_stragglers_total",
            "counter",
            "Straggler events per replica",
            [({"replica": rid}, n) for rid, n in snap.stragglers_by_replica],
        )
    if snap.per_class:
        for field in ("submitted", "completed", "shed", "expired", "rejected"):
            _prom(
                lines,
                f"pc2im_serve_class_{field}_total",
                "counter",
                f"Per-SLO-class {field} requests",
                [({"slo": cs.name}, getattr(cs, field)) for cs in snap.per_class],
            )
        _prom(
            lines,
            "pc2im_serve_class_latency_seconds",
            "gauge",
            "Per-SLO-class latency percentiles",
            [
                ({"slo": cs.name, "quantile": q}, v)
                for cs in snap.per_class
                for q, v in (("0.5", cs.latency_p50_s), ("0.95", cs.latency_p95_s))
            ],
        )
        _prom(
            lines,
            "pc2im_serve_class_depth_hwm",
            "gauge",
            "Per-SLO-class admission-lane depth high-water mark",
            [({"slo": cs.name}, cs.depth_hwm) for cs in snap.per_class],
        )
    return "\n".join(lines) + "\n"


# -- periodic reporter --------------------------------------------------------


class Reporter:
    """Daemon thread that periodically reports one runtime's metrics.

    Every ``interval_s`` it snapshots the :class:`ServeMetrics`, appends the
    tracer's buffer occupancy when tracing is on, and hands the one-line
    summary to ``sink`` (default: write to stderr).  The latest snapshot
    stays readable at :attr:`last_snapshot` so operators can poll state
    without parsing the sink output.  `report_once()` drives a single tick
    synchronously for tests.
    """

    def __init__(self, metrics, interval_s: float, *, sink=None, tracer=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.metrics = metrics
        self.interval_s = interval_s
        self.sink = sink if sink is not None else self._default_sink
        self.tracer = tracer
        self.last_snapshot: MetricsSnapshot | None = None
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _default_sink(line: str) -> None:
        print(line, file=sys.stderr)

    def report_once(self) -> str:
        """One reporting tick: snapshot, format, sink; returns the line."""
        snap = self.metrics.snapshot()
        self.last_snapshot = snap
        self.ticks += 1
        line = f"[serve] {snap.format_row()}"
        if self.tracer is not None:
            line += (
                f" trace={len(self.tracer)}ev"
                f" dropped={self.tracer.dropped}"
            )
        self.sink(line)
        return line

    def start(self) -> "Reporter":
        """Spawn the reporting thread (idempotent); returns self."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="pc2im-reporter"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the reporting thread, emitting one final tick."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
            self.report_once()  # final state, so short runs still report

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.report_once()


class MetricsServer:
    """Opt-in live scrape endpoint over one runtime's ServeMetrics.

    A stdlib ``ThreadingHTTPServer`` (no dependencies) serving
    ``GET /metrics`` — :func:`prometheus_text` of a fresh snapshot — and
    ``GET /healthz`` for liveness probes.  Lifecycle mirrors
    :class:`Reporter`: the runtime starts it in ``start()`` and tears it
    down in ``stop()``.  ``port=0`` binds an ephemeral port; read the
    resolved address from :attr:`url` after :meth:`start`.
    """

    def __init__(self, metrics, *, host: str = "127.0.0.1", port: int = 0):
        self.metrics = metrics
        self.host = host
        self.port = port
        self._server = None
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        """Base URL of the listener (port resolved after start())."""
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        """Bind and serve in a daemon thread (idempotent); returns self."""
        if self._server is not None:
            return self
        import http.server

        metrics = self.metrics

        class Handler(http.server.BaseHTTPRequestHandler):
            """Two-route scrape handler: /metrics (Prometheus) + /healthz."""

            def do_GET(self):  # noqa: N802 — http.server API
                """Serve one GET; unknown paths get 404."""
                if self.path == "/metrics":
                    body = prometheus_text(metrics.snapshot()).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/healthz":
                    body = b"ok\n"
                    ctype = "text/plain; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                """Silenced — periodic scrapes must not spam stderr."""

        self._server = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler
        )
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="pc2im-metrics-http",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the listener down and join the serving thread."""
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
