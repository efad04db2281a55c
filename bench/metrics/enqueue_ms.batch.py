"""Host time of one `PC2IMAccelerator.infer` call: the median of the benchmark's own span
around it (the batch copied into the graph's input, the replay enqueued, the logits
cloned), over the window's batches outside the profiled stretch."""

import statistics

LAYER = "entry point and graphs"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "clouds_per_s"
SPAN = "bench: infer (copy in, replay)"


def read(run):
    """The median in ms, or None without spans."""
    inside = (run.stretch.t0, run.stretch.t1) if run.stretch is not None else (0.0, 0.0)
    ms = [(t1 - t0) * 1e3 for label, t0, t1 in run.spans
          if label == SPAN and not (inside[0] <= t0 <= inside[1])]
    return statistics.median(ms) if ms else None
