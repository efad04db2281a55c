"""Time the replica takes for one micro-batch: the median over the window's batches of the
runtime's own trace edges batch.execute_start -> batch.execute_end (serve/dispatch.py: the
batch copied into the graph's input, the replay, the logits read back), of the batches done
before the profiled stretch began (its start stalls the host)."""

import statistics

LAYER = "serving, replica pool"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms"


def read(run):
    """The median in ms, or None without traced batches."""
    start, ms = {}, []
    for e in run.events:
        if e.name == "batch.execute_start":
            start[e.batch_id] = e.t
        elif e.name == "batch.execute_end" and e.batch_id in start and e.t < run.quiet_until:
            ms.append((e.t - start.pop(e.batch_id)) * 1e3)
    return statistics.median(ms) if ms else None
