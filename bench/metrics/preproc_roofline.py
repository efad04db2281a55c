"""The preprocessing kernels' share of their roofline: the least time of the fps, lattice
and knn3 calls in the profiled stretch (bench/work.py; the lattice query's operations are
the points each row scanned, counted by the reference) over their device time.  Kernels are
matched by the names below."""

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "clouds_per_s"
KERNELS = ("fps_warp_kernel", "fps_tiles_kernel", "lattice_kernel", "knn3_kernel")


def read(run):
    """The share in %, or None without a profiled stretch."""
    st = run.stretch
    if st is None or not run.stretch_pool or not run.preproc_least_s:
        return None
    count, secs = st.kernel_time(KERNELS)
    if count == 0 or secs <= 0:
        return None
    least = sum(sum(run.preproc_least_s[j].values()) for j in run.stretch_pool)
    return 100.0 * least / secs
