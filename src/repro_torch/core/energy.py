"""Analytic energy / cycle models reproducing the paper's evaluation figures.

Pure math (no torch): the port's own copy of the JAX package's model, so
that the port's tooling reads it without that package.

The paper evaluates PC2IM purely on *speedup* and *energy efficiency*, derived
from synthesis + CACTI memory-energy constants (Table II).  This module
rebuilds those models from the paper's stated facts:

  Table II   : SRAM 0.7 pJ/bit, DRAM 4.5 pJ/bit, 250 MHz, 2 TOPS @16b,
               2.53 TOPS/W, APD-CIM 12KB (2048 pts x 48b), CAM 19KB.
  Challenge I: in tiled (local) FPS, on-chip access = 99% of traffic;
               41% point reads vs 58% temporary-distance (TD) update.
               -> TD update is read+write of d bits/point/iter; solving
               48 : 2d = 41 : 58 gives d = 34 bits, i.e. squared-L2 of
               16-bit coords (33b + guard) — the paper's L2 TD width.
               L1 TDs are 19 bits (3*(2^16-1) < 2^19)  -> the C1 saving.
  APD-CIM    : 16 L1 distances produced per cycle (one PTG row activation).
  Ping-Pong  : bit-serial MSB->LSB max search, 19 cycles/sample, mismatching
               rows self-disable (expected active-cell work ~ 2P cell-bits).

CIM-internal per-bit energies are NOT given by the paper; we expose them as
two calibration constants fitted (see `calibrate_cim`) to the paper's two
headline preprocessing claims (97.9% vs baseline-1, 73.4% vs baseline-2) and
report fitted values + residuals.
"""

from __future__ import annotations

import dataclasses
import math

# ---------------------------------------------------------------------------
# Constants from the paper (Table II + Challenge I)
# ---------------------------------------------------------------------------

E_SRAM_PJ_BIT = 0.7
E_DRAM_PJ_BIT = 4.5
FREQ_HZ = 250e6
COORD_BITS = 16
POINT_BITS = 3 * COORD_BITS  # 48
TD_BITS_L2 = 34  # derived from the 41:58 split (see module docstring)
TD_BITS_L1 = 19  # paper: "16 19-bit L1 distances"
CIM_TILE_POINTS = 2048  # APD-CIM capacity (12KB @ 48b/pt)
DIST_PER_CYCLE = 16  # one PTG row -> 16 PTCs in parallel
MAX_SEARCH_CYCLES = TD_BITS_L1  # bit-serial MSB->LSB
ONCHIP_ROW_BITS = 256  # digital SRAM row width (baselines)
DRAM_BITS_PER_CYCLE = 128  # ~4 GB/s @ 250 MHz — edge-DRAM assumption


@dataclasses.dataclass(frozen=True)
class CIMConstants:
    """Calibrated CIM-internal energies (pJ)."""

    e_cim_dist_pj: float = 1.4  # one in-array L1 distance (48 bit-ops)
    e_cam_td_pj: float = 0.9  # one in-situ TD compare+conditional-update (19b)
    e_cam_srch_cellbit_pj: float = 0.02  # per active cell-bit of max search
    e_digital_per_dist_pj: float = 0.12  # sorter/merger share per distance


@dataclasses.dataclass(frozen=True)
class PreprocWorkload:
    """One set-abstraction preprocessing stage."""

    n_points: int  # raw cloud size N
    n_centroids: int  # M sampled
    nsample: int  # neighbours per centroid
    tile_points: int = CIM_TILE_POINTS  # P (equal-size tiles, MSP)
    grid_capacity_factor: float = 2.0  # baseline-2 padding (fixed tiles)

    @property
    def n_tiles(self) -> int:
        """Equal-size tiles of `tile_points` (at least one)."""
        return max(1, self.n_points // self.tile_points)

    @property
    def k_per_tile(self) -> int:
        """Centroids sampled per tile (at least one)."""
        return max(1, self.n_centroids // self.n_tiles)


# Dataset points from the paper's Table I (ModelNet 1k / S3DIS 4k / KITTI 16k),
# with PointNet2 SA-1 sampling ratios (M = N/4, nsample = 32).
WORKLOADS = {
    "modelnet_1k": PreprocWorkload(n_points=1024, n_centroids=256, nsample=32, tile_points=1024),
    "s3dis_4k": PreprocWorkload(n_points=4096, n_centroids=1024, nsample=32),
    "semantickitti_16k": PreprocWorkload(n_points=16384, n_centroids=4096, nsample=32),
}


# ---------------------------------------------------------------------------
# Energy: data preprocessing (Fig 12b)
# ---------------------------------------------------------------------------

def preproc_energy_baseline1(w: PreprocWorkload) -> dict:
    """Global digital FPS + global ball query; points re-read from DRAM each iter."""
    n, m = w.n_points, w.n_centroids
    fps_point = m * n * POINT_BITS * E_DRAM_PJ_BIT
    fps_td = m * n * 2 * TD_BITS_L2 * E_SRAM_PJ_BIT  # read+write per iter
    query_point = m * n * POINT_BITS * E_DRAM_PJ_BIT
    return _pack(dram_load=0.0, fps_point=fps_point, fps_td=fps_td, query=query_point)


def preproc_energy_baseline2(w: PreprocWorkload) -> dict:
    """TiPU-like: one DRAM load, fixed grid tiles (padded), local digital L2 FPS."""
    n = w.n_points
    p_cap = int(w.tile_points * w.grid_capacity_factor)  # padded capacity reads
    t, k = w.n_tiles, w.k_per_tile
    dram = n * POINT_BITS * E_DRAM_PJ_BIT
    fps_point = t * k * p_cap * POINT_BITS * E_SRAM_PJ_BIT
    fps_td = t * k * w.tile_points * 2 * TD_BITS_L2 * E_SRAM_PJ_BIT
    query_point = w.n_centroids * p_cap * POINT_BITS * E_SRAM_PJ_BIT
    return _pack(dram_load=dram, fps_point=fps_point, fps_td=fps_td, query=query_point)


def preproc_energy_pc2im(w: PreprocWorkload, c: CIMConstants = CIMConstants()) -> dict:
    """PC2IM: one DRAM load, MSP equal tiles, in-CIM L1 distance, in-CAM TD+max."""
    n = w.n_points
    p = w.tile_points  # MSP: zero padding
    t, k = w.n_tiles, w.k_per_tile
    dram = n * POINT_BITS * E_DRAM_PJ_BIT
    # FPS: distances computed in-array; TDs updated in-situ; bit-serial max
    # search touches ~2P effective cell-bits (rows self-disable on mismatch).
    fps_dist = t * k * p * c.e_cim_dist_pj
    fps_td = t * k * p * c.e_cam_td_pj
    fps_max = t * k * 2 * p * c.e_cam_srch_cellbit_pj * 1.0
    # Lattice query: one more in-array distance pass per centroid + sorter.
    query = w.n_centroids * p * (c.e_cim_dist_pj + c.e_digital_per_dist_pj)
    return _pack(dram_load=dram, fps_point=fps_dist, fps_td=fps_td + fps_max, query=query)


def _pack(**parts: float) -> dict:
    parts["total_pj"] = sum(parts.values())
    return parts


def calibrate_cim(w: PreprocWorkload | None = None) -> tuple[CIMConstants, dict]:
    """Fit (e_cim_dist, e_cam_td) to the paper's 97.9% / 73.4% claims.

    Grid-search within physically sensible 40nm bounds (in-array ops are
    0.2x-0.6x an SRAM read of the same width).  Returns constants + report.
    """
    w = w or WORKLOADS["semantickitti_16k"]
    e1 = preproc_energy_baseline1(w)["total_pj"]
    e2 = preproc_energy_baseline2(w)["total_pj"]
    target1, target2 = 0.979, 0.734

    best, best_err = None, math.inf
    sram_dist = POINT_BITS * E_SRAM_PJ_BIT  # 33.6 pJ — upper bound anchor
    sram_td = TD_BITS_L1 * E_SRAM_PJ_BIT  # 13.3 pJ
    for fd in [x / 100 for x in range(2, 62, 2)]:  # dist op: 2%..60% of SRAM read
        for ft in [x / 100 for x in range(2, 62, 2)]:
            c = CIMConstants(
                e_cim_dist_pj=fd * sram_dist,
                e_cam_td_pj=ft * sram_td,
            )
            ep = preproc_energy_pc2im(w, c)["total_pj"]
            r1, r2 = 1 - ep / e1, 1 - ep / e2
            err = (r1 - target1) ** 2 + (r2 - target2) ** 2
            if err < best_err:
                best, best_err = c, err
    ep = preproc_energy_pc2im(w, best)["total_pj"]
    report = {
        "fitted_e_cim_dist_pj": best.e_cim_dist_pj,
        "fitted_e_cam_td_pj": best.e_cam_td_pj,
        "reduction_vs_baseline1": 1 - ep / e1,
        "claimed_vs_baseline1": target1,
        "reduction_vs_baseline2": 1 - ep / e2,
        "claimed_vs_baseline2": target2,
        "baseline1_total_uj": e1 * 1e-6,
        "baseline2_total_uj": e2 * 1e-6,
        "pc2im_total_uj": ep * 1e-6,
    }
    return best, report


# ---------------------------------------------------------------------------
# Cycles: data preprocessing latency
# ---------------------------------------------------------------------------

def preproc_cycles_baseline1(w: PreprocWorkload) -> float:
    """Global FPS and query, each streaming the whole cloud from DRAM per centroid."""
    per_iter = w.n_points * POINT_BITS / DRAM_BITS_PER_CYCLE  # DRAM-bound stream
    query = w.n_centroids * w.n_points * POINT_BITS / DRAM_BITS_PER_CYCLE
    return w.n_centroids * per_iter + query


def preproc_cycles_baseline2(w: PreprocWorkload) -> float:
    """One DRAM load, then padded grid tiles streamed row by row from on-chip SRAM."""
    p_cap = int(w.tile_points * w.grid_capacity_factor)
    per_iter = p_cap * POINT_BITS / ONCHIP_ROW_BITS  # SRAM row streaming
    query = w.n_centroids * p_cap * POINT_BITS / ONCHIP_ROW_BITS
    load = w.n_points * POINT_BITS / DRAM_BITS_PER_CYCLE
    return load + w.n_tiles * w.k_per_tile * per_iter + query


def preproc_cycles_pc2im(w: PreprocWorkload) -> float:
    """16 dists/cycle; ping-pong overlaps the 19-cycle max search with the next
    tile's distance pass (array-level ping-pong), so max is mostly hidden."""
    p = w.tile_points
    per_iter = p / DIST_PER_CYCLE + MAX_SEARCH_CYCLES * 0.25  # mostly overlapped
    query = w.n_centroids * (p / DIST_PER_CYCLE)
    load = w.n_points * POINT_BITS / DRAM_BITS_PER_CYCLE
    return load + w.n_tiles * w.k_per_tile * per_iter + query


# ---------------------------------------------------------------------------
# SC-CIM FoM model (Fig 12c): BS-CIM vs BT-CIM vs SC-CIM over SCR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MacScheme:
    """One 16-bit MAC scheme of the SC-CIM comparison: cycles, area and energy units."""

    name: str
    cycles_per_input: int  # 16-bit input: bit-serial 16 / booth 8 / SC 4
    compute_area_units: float  # area of compute logic per column, SRAM-row units
    energy_per_cycle_units: float  # adder-tree switch energy per active cycle


# Calibrated so FoM2 ratios reproduce the paper's endpoints:
#   SCR=8:  SC/BS=5.2, SC/BT=2.0;   SCR->inf: SC/BS->9.9, SC/BT->2.8  (Fig 12c)
# (asymptotes: 4x throughput * 16/(4*1.62) = 9.88; 2x * (8*1.134)/(4*1.62) = 2.80)
MAC_SCHEMES = {
    "bs_cim": MacScheme("bs_cim", 16, compute_area_units=2.0, energy_per_cycle_units=1.0),
    "bt_cim": MacScheme("bt_cim", 8, compute_area_units=5.86, energy_per_cycle_units=1.134),
    "sc_cim": MacScheme("sc_cim", 4, compute_area_units=11.0, energy_per_cycle_units=1.62),
}


def sccim_fom(scr: int, scheme: str) -> dict:
    """FoM2 = throughput / (area * energy_per_mac) — normalised units.

    scr = SRAM rows sharing one compute unit; larger scr amortises compute
    area (the paper's storage-compute-ratio sweep).
    """
    s = MAC_SCHEMES[scheme]
    throughput = 1.0 / s.cycles_per_input  # MACs/cycle/column (16-bit MAC)
    area = scr * 1.0 + s.compute_area_units  # SRAM rows + compute logic
    energy_per_mac = s.cycles_per_input * s.energy_per_cycle_units
    fom2 = throughput / (area * energy_per_mac) * 1e3
    return {
        "scheme": scheme,
        "scr": scr,
        "throughput_macs_per_cycle": throughput,
        "area_units": area,
        "energy_per_mac_units": energy_per_mac,
        "fom2": fom2,
    }


# ---------------------------------------------------------------------------
# System-level model (Fig 13): PCN latency + energy per platform
# ---------------------------------------------------------------------------

def sa_stage_workloads(n_points: int) -> list[PreprocWorkload]:
    """PointNet2 set-abstraction pyramid: each stage samples N/4 centroids."""
    stages = []
    n = n_points
    for _ in range(3):
        m = n // 4
        stages.append(
            PreprocWorkload(
                n_points=n, n_centroids=m, nsample=32, tile_points=min(CIM_TILE_POINTS, n)
            )
        )
        n = m
    return stages


@dataclasses.dataclass(frozen=True)
class PCNWorkload:
    """Per-frame workload for a PointNet2 variant on a dataset."""

    name: str
    stages: list[PreprocWorkload]
    total_macs: float  # feature-computing MACs per frame

    @property
    def total_fps_iters(self) -> int:
        """FPS iterations of a frame: one per sampled centroid, over every stage."""
        return sum(s.n_centroids for s in self.stages)


def pointnet2_macs(n_points: int, seg: bool) -> float:
    """Per-frame MAC count for PointNet2 (c)/(s) — mirrors models/pointnet2
    channel plans (delayed aggregation: per-point MLPs)."""
    chans = [(3, 64, 64, 128), (128, 128, 128, 256), (256, 256, 512, 1024)]
    pts = [n_points, n_points // 4, n_points // 16]
    macs = 0.0
    for p, cs in zip(pts, chans):
        for cin, cout in zip(cs[:-1], cs[1:]):
            macs += p * cin * cout
    if seg:  # FP stages mirror SA
        macs *= 1.8
    else:  # classifier head
        macs += 1024 * 512 + 512 * 256 + 256 * 40
    return macs


def make_pcn_workload(n_points: int, seg: bool, name: str = "") -> PCNWorkload:
    """The PointNet2 (c)/(s) frame workload at n_points: SA stages and MAC count."""
    return PCNWorkload(
        name=name or f"pointnet2_{'s' if seg else 'c'}_{n_points}",
        stages=sa_stage_workloads(n_points),
        total_macs=pointnet2_macs(n_points, seg),
    )


@dataclasses.dataclass(frozen=True)
class SystemConstants:
    """Platform free-parameters not given by the paper — calibrated by
    `calibrate_system` against the paper's speedup ratios and documented."""

    tipu_dist_per_cycle: int = 64  # near-memory banks x per-bank units (TiPU [10])
    b1_dram_bits_per_cycle: int = 1024  # baseline-1 DRAM stream width (32 GB/s)
    gpu_fps_iter_latency_s: float = 5e-6  # per-iteration kernel launch + reduce
    gpu_tops_16b: float = 82.6  # RTX4090 fp16 tensor peak
    gpu_mlp_util: float = 0.06  # achieved utilisation on small PCN matmuls
    gpu_power_w: float = 97.0  # measured board power under latency-bound PCN load (not TDP)
    pc2im_tops_16b: float = 2.0  # Table II
    pc2im_power_w: float = 2.0 / 2.53  # Table II: 2.53 TOPS/W
    tipu_tops_16b: float = 0.5  # BS-CIM: 4x more cycles than SC-CIM
    tipu_power_w: float = 0.5 / 1.8


def _preproc_cycles_platform(w: PreprocWorkload, platform: str, sc: SystemConstants) -> float:
    if platform == "pc2im":
        return preproc_cycles_pc2im(w)
    if platform == "baseline2_tipu":
        p_cap = int(w.tile_points * w.grid_capacity_factor)
        per_iter = p_cap / sc.tipu_dist_per_cycle
        query = w.n_centroids * per_iter
        load = w.n_points * POINT_BITS / DRAM_BITS_PER_CYCLE
        return load + w.n_tiles * w.k_per_tile * per_iter + query
    if platform == "baseline1":
        per_iter = w.n_points * POINT_BITS / sc.b1_dram_bits_per_cycle
        return w.n_centroids * per_iter * 2.0  # FPS + query both stream globally
    raise ValueError(platform)


def system_latency_s(
    workload: PCNWorkload, platform: str, sc: SystemConstants = SystemConstants()
) -> dict:
    """Per-frame latency decomposition.  GPU preprocessing is latency-bound
    (serial FPS: one kernel launch + global argmax reduction per sample —
    why FPS hits 70% of PCN runtime on GPUs [3])."""
    if platform == "gpu":
        pre_s = workload.total_fps_iters * sc.gpu_fps_iter_latency_s
        mlp_s = 2 * workload.total_macs / (sc.gpu_tops_16b * sc.gpu_mlp_util * 1e12)
    else:
        pre_s = sum(
            _preproc_cycles_platform(s, platform, sc) for s in workload.stages
        ) / FREQ_HZ
        tops = {
            "pc2im": sc.pc2im_tops_16b,
            "baseline2_tipu": sc.tipu_tops_16b,
            "baseline1": sc.tipu_tops_16b,  # b1 uses the same near-memory MLP
        }[platform]
        mlp_s = 2 * workload.total_macs / (tops * 1e12)
    return {"preproc_s": pre_s, "mlp_s": mlp_s, "total_s": pre_s + mlp_s}


def system_energy_j(
    workload: PCNWorkload,
    platform: str,
    sc: SystemConstants = SystemConstants(),
    cim: CIMConstants | None = None,
) -> float:
    """Per-frame energy: accelerators = preproc access-energy + MLP core power;
    GPU = board power x latency."""
    lat = system_latency_s(workload, platform, sc)
    if platform == "gpu":
        return sc.gpu_power_w * lat["total_s"]
    pre_fn = {
        "pc2im": lambda w: preproc_energy_pc2im(w, cim or CIMConstants()),
        "baseline2_tipu": preproc_energy_baseline2,
        "baseline1": preproc_energy_baseline1,
    }[platform]
    pre_j = sum(pre_fn(s)["total_pj"] for s in workload.stages) * 1e-12
    power = {
        "pc2im": sc.pc2im_power_w,
        "baseline2_tipu": sc.tipu_power_w,
        "baseline1": sc.tipu_power_w,
    }[platform]
    return pre_j + power * lat["mlp_s"]


def calibrate_system(workload: PCNWorkload | None = None) -> tuple[SystemConstants, dict]:
    """Fit the 3 platform free-parameters to the paper's speedup claims:
    1.5x vs TiPU (abstract, 'SOTA accelerator'), 6.0x vs baseline-1,
    3.5x vs GPU (SemanticKITTI).  Grid-search, report residuals."""
    w = workload or make_pcn_workload(16384, seg=True)
    targets = {"baseline2_tipu": 1.5, "baseline1": 6.0, "gpu": 3.5}
    best, best_err = None, math.inf
    for tipu_t in [16, 32, 48, 64, 96, 128]:
        for b1_w in [256, 512, 1024, 2048, 4096]:
            for gpu_lat in [2e-6, 3e-6, 5e-6, 8e-6, 12e-6, 20e-6]:
                sc = SystemConstants(
                    tipu_dist_per_cycle=tipu_t,
                    b1_dram_bits_per_cycle=b1_w,
                    gpu_fps_iter_latency_s=gpu_lat,
                )
                t_pc = system_latency_s(w, "pc2im", sc)["total_s"]
                err = 0.0
                for plat, tgt in targets.items():
                    sp = system_latency_s(w, plat, sc)["total_s"] / t_pc
                    err += (math.log(sp) - math.log(tgt)) ** 2
                if err < best_err:
                    best, best_err = sc, err
    t_pc = system_latency_s(w, "pc2im", best)["total_s"]
    e_pc = system_energy_j(w, "pc2im", best)
    report = {"pc2im_ms": t_pc * 1e3, "pc2im_mj": e_pc * 1e3}
    for plat, tgt in targets.items():
        sp = system_latency_s(w, plat, best)["total_s"] / t_pc
        ee = system_energy_j(w, plat, best) / e_pc
        report[f"speedup_vs_{plat}"] = sp
        report[f"claimed_speedup_vs_{plat}"] = tgt
        report[f"energy_eff_vs_{plat}"] = ee
    report["claimed_energy_eff_vs_baseline2_tipu"] = 2.7
    report["claimed_energy_eff_vs_gpu"] = 1518.9
    return best, report
