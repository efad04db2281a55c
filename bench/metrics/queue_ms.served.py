"""Time a served request waits before its micro-batch is assembled: the median over the
window's requests of the runtime's own trace edges request.submit -> request.assembled
(serve/trace.py; the queue's lane, the drain tick and the batching wait), of the requests
assembled before the profiled stretch began (its start stalls the host)."""

import statistics

LAYER = "serving, queue and scheduler"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms"


def read(run):
    """The median in ms, or None without traced requests."""
    submit, ms = {}, []
    for e in run.events:
        if e.name == "request.submit":
            submit[e.trace_id] = e.t
        elif e.name == "request.assembled" and e.trace_id in submit and e.t < run.quiet_until:
            ms.append((e.t - submit[e.trace_id]) * 1e3)
    return statistics.median(ms) if ms else None
