"""The whole forward's share of the card's dense 16-bit peak (989 TFLOP/s) over the profiled
stretch: model FLOPs of a cloud (bench/work.py, 2 per multiply-accumulate of every linear as
the configuration executes it) times the clouds the stretch completed, over its length."""

from bench import work

LAYER = "model and engine"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "clouds_per_s"


def read(run):
    """The share in %, or None without a profiled stretch."""
    st = run.stretch
    if st is None or not run.stretch_pool:
        return None
    flops = work.model_flops_per_cloud(run.cfg) * run.batch * len(run.stretch_pool)
    return 100.0 * flops / st.window_s / work.PEAK_BF16_FLOPS
