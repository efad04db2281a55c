"""The SC matmul kernel's share of its roofline: the least time of its calls in the profiled
stretch (bench/work.py: the logical 2·M·K·N at the int8 peak, or its bytes at 3.35 TB/s,
whichever is longer) over their device time.  Kernels are matched by the names below."""

from bench import work

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "clouds_per_s"
KERNELS = ("sc_matmul_kernel", "sc_matmul_res_kernel")


def read(run):
    """The share in %, or None where no SC call ran in the stretch."""
    st = run.stretch
    if st is None or not run.stretch_pool or not run.launches.get("sc_matmul"):
        return None
    count, secs = st.kernel_time(KERNELS)
    if count == 0 or secs <= 0:
        return None
    least = sum(work.sc_least_time(m, k, n) for m, k, n in work.sc_calls(run.cfg, run.batch))
    return 100.0 * least * len(run.stretch_pool) / secs
