"""How full the served micro-batches ran: the mean of n_real / batch_size over the runtime's
own BatchRecord of every batch assembled in the window before the profiled stretch began
(serve/metrics.py)."""

LAYER = "serving, queue and scheduler"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "latency_p95_ms"


def read(run):
    """The mean in %, or None without batches."""
    ids = {e.batch_id for e in run.events
           if e.name == "batch.assembled" and e.t < run.quiet_until}
    fills = [r.n_real / r.batch_size for r in run.batch_records if r.batch_id in ids]
    return 100.0 * sum(fills) / len(fills) if fills else None
