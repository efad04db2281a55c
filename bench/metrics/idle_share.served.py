"""The card's idle share over the profiled stretch of the open loop: 1 - the union of its
device records' intervals over the stretch's length."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "latency_p95_ms"


def read(run):
    """The share in %, or None without device records."""
    st = run.stretch
    if st is None or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
