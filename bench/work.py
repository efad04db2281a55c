"""The benchmark's yardsticks: the card's peaks, model FLOPs and each kernel's least time.

Frozen here so that no change to the program can move them.

* Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
  3.35 TB/s of HBM, 989 TFLOP/s in 16-bit on the tensor cores (the
  denominator of every `mfu`), 1,979 TOP/s in int8; single float32
  instructions at 132 SMs x 128 lanes x 1.98 GHz = 33.5 T/s.  A card set
  below 700 W runs slower: every share is printed beside the card's limit.
* Model FLOPs: 2 per multiply-accumulate of every linear layer, at the
  configuration's shapes as it executes them (delayed aggregation: the SA
  MLPs run once a point, the global MLP once a centroid, the FP MLPs and
  the seg head once a point of their level).
* Kernel work: the bytes each call must move (every input read once,
  every output written once) and its operations.  FPS, lattice and 3-NN
  count single float32 instructions (their builds use no fused
  multiply-add): an L1 distance is 3 sub and 2 add, a squared L2 one 3
  more mul; FPS adds a min and a compare a point a step, the lattice query
  a compare a point it scans (a row stops at its nsample-th hit), 3-NN a
  compare a (query, point) pair.  The SC matmul counts the logical
  product, 2·M·K·N at the int8 rate, whatever planes or splits the kernel
  uses: the same work reads the same however it is cut.

A call's least time is max(bytes / 3.35 TB/s, operations / its peak).
"""

from __future__ import annotations

from bench.reference.pointnet2 import clamp_depth

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_INSTR = 33.5e12
DISTANCE_INSTR = {"l1": 5, "l2": 8}


def linear_shapes(cfg: dict) -> list[tuple[str, int, int, int]]:
    """(stack, rows a cloud, d_in, d_out) of every linear of one cloud's forward."""
    out = []

    def stack(name, rows, channels):
        for cin, cout in zip(channels[:-1], channels[1:]):
            out.append((name, rows, cin, cout))

    n = cfg["n_points"]
    c_in = 3 + cfg["in_features"]
    level_points = [n]
    for i, sa in enumerate(cfg["sa"]):
        stack(f"sa.{i}", level_points[-1], [c_in, *sa["mlp"]])
        c_in = sa["mlp"][-1] + 3
        level_points.append(sa["n_centroids"])
    sa_out = cfg["sa"][-1]["mlp"][-1]
    if cfg["task"] == "cls":
        stack("global_mlp", level_points[-1], [sa_out + 3, *cfg["global_mlp"]])
        stack("head", 1, [cfg["global_mlp"][-1], *cfg["head"], cfg["n_classes"]])
        return out
    skips = [3 + cfg["in_features"]] + [sa["mlp"][-1] for sa in cfg["sa"][:-1]]
    c_coarse, n_fp = sa_out, len(cfg["sa"])
    for i, skip_c in enumerate(reversed(skips)):
        cout = cfg["fp_mlp"][min(i, len(cfg["fp_mlp"]) - 1)]
        stack(f"fp.{i}", level_points[n_fp - 1 - i], [c_coarse + skip_c, cout, cout])
        c_coarse = cout
    stack("head", n, [c_coarse, *cfg["head"], cfg["n_classes"]])
    return out


def model_flops_per_cloud(cfg: dict) -> int:
    """2 x the multiply-accumulates of every linear of one cloud's forward."""
    return sum(2 * rows * cin * cout for _, rows, cin, cout in linear_shapes(cfg))


def least_time(nbytes: float, ops: float, peak: float) -> float:
    """Seconds a call needs at the card's peaks: the larger of its two bounds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak)


def sc_calls(cfg: dict, batch: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of each SC matmul call of a forward of `batch` clouds (one a linear)."""
    return [(batch * rows, cin, cout) for _, rows, cin, cout in linear_shapes(cfg)]


def sc_least_time(m: int, k: int, n: int) -> float:
    """Least time of an (M, K) x (K, N) int32 product to float32: the logical 2·M·K·N."""
    return least_time((m * k + k * n + m * n) * 4, 2 * m * k * n, PEAK_INT8_OPS)


def fps_least_time(t: int, p: int, k: int, metric: str = "l1") -> float:
    """FPS of k samples in each of t tiles of p points: distance, min and compare a step."""
    nbytes = t * p * 3 * 4 + t * k * 4
    ops = (DISTANCE_INSTR[metric] + 2) * t * p * (k - 1)
    return least_time(nbytes, ops, PEAK_F32_INSTR)


def lattice_least_time(t: int, p: int, k: int, nsample: int, scanned: int) -> float:
    """Lattice query of k centroids in each of t tiles of p points; `scanned` points read."""
    nbytes = t * k * 3 * 4 + t * p * 3 * 4 + t * k * nsample * (4 + 1)
    ops = (DISTANCE_INSTR["l1"] + 1) * scanned
    return least_time(nbytes, ops, PEAK_F32_INSTR)


def knn3_least_time(b: int, q: int, p: int, k: int = 3) -> float:
    """k nearest (squared L2) of q queries among p points, in each of b clouds."""
    nbytes = b * (q + p) * 3 * 4 + b * q * k * 8
    ops = (DISTANCE_INSTR["l2"] + 1) * b * q * p
    return least_time(nbytes, ops, PEAK_F32_INSTR)


def preproc_least_time(cfg: dict, batch: int, scanned: list[int]) -> dict[str, float]:
    """Least seconds of a forward's fps, lattice and knn3 calls, by kernel.

    `scanned` gives, per SA stage, the points the lattice query reads over
    the whole batch (the reference's `preprocess` counts them).
    """
    out = {"fps": 0.0, "lattice": 0.0, "knn3": 0.0}
    n = cfg["n_points"]
    level_points = [n]
    for sa, sc in zip(cfg["sa"], scanned):
        depth = clamp_depth(n, sa["n_centroids"], cfg["msp_depth"])
        t = batch << depth
        p, k = n >> depth, sa["n_centroids"] >> depth
        out["fps"] += fps_least_time(t, p, k)
        out["lattice"] += lattice_least_time(t, p, k, sa["nsample"], sc)
        n = sa["n_centroids"]
        level_points.append(n)
    if cfg["task"] == "seg":
        for i in range(len(cfg["sa"])):
            out["knn3"] += knn3_least_time(batch, level_points[-2 - i], level_points[-1 - i])
    return out


def launches_per_forward(cfg: dict, quant: str) -> dict[str, int]:
    """Kernel launches of one forward, by kernel family: what a profiled stretch must hold."""
    n_sa = len(cfg["sa"])
    out = {"fps": n_sa, "lattice": n_sa, "knn3": n_sa if cfg["task"] == "seg" else 0,
           "sc_matmul": len(linear_shapes(cfg)) if quant != "none" else 0}
    return out
