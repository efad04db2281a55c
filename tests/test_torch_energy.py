"""Port parity, the analytic energy / cycle model: every function of the port's
`core/energy.py` against the JAX package's `core/energy.py`, compared with
`==` (the same pure Python float arithmetic in the same order), on the
paper's workloads and a few more."""

import dataclasses

import pytest

from repro.core import energy as JEn
from repro_torch.core import energy as TEn

EXTRA = [TEn.PreprocWorkload(n_points=2048, n_centroids=512, nsample=16),
         TEn.PreprocWorkload(n_points=8192, n_centroids=1024, nsample=32, tile_points=1024,
                             grid_capacity_factor=3.0)]


def _j(w: TEn.PreprocWorkload) -> JEn.PreprocWorkload:
    return JEn.PreprocWorkload(**dataclasses.asdict(w))


def _workloads():
    return list(TEn.WORKLOADS.values()) + EXTRA


def test_constants_and_workloads_equal():
    for name in ("E_SRAM_PJ_BIT", "E_DRAM_PJ_BIT", "FREQ_HZ", "COORD_BITS", "POINT_BITS",
                 "TD_BITS_L2", "TD_BITS_L1", "CIM_TILE_POINTS", "DIST_PER_CYCLE",
                 "MAX_SEARCH_CYCLES", "ONCHIP_ROW_BITS", "DRAM_BITS_PER_CYCLE"):
        assert getattr(TEn, name) == getattr(JEn, name), name
    assert {k: dataclasses.asdict(v) for k, v in TEn.WORKLOADS.items()} == {
        k: dataclasses.asdict(v) for k, v in JEn.WORKLOADS.items()}
    assert dataclasses.asdict(TEn.CIMConstants()) == dataclasses.asdict(JEn.CIMConstants())
    assert dataclasses.asdict(TEn.SystemConstants()) == dataclasses.asdict(JEn.SystemConstants())
    assert ({k: dataclasses.asdict(v) for k, v in TEn.MAC_SCHEMES.items()}
            == {k: dataclasses.asdict(v) for k, v in JEn.MAC_SCHEMES.items()})
    for w in _workloads():
        assert (w.n_tiles, w.k_per_tile) == (_j(w).n_tiles, _j(w).k_per_tile)


@pytest.mark.parametrize("kind", ["baseline1", "baseline2", "pc2im"])
def test_preproc_energy_and_cycles_equal(kind):
    for w in _workloads():
        assert (getattr(TEn, f"preproc_energy_{kind}")(w)
                == getattr(JEn, f"preproc_energy_{kind}")(_j(w)))
        assert (getattr(TEn, f"preproc_cycles_{kind}")(w)
                == getattr(JEn, f"preproc_cycles_{kind}")(_j(w)))
    c = TEn.CIMConstants(e_cim_dist_pj=3.0, e_cam_td_pj=0.5)
    jc = JEn.CIMConstants(**dataclasses.asdict(c))
    for w in _workloads():
        assert TEn.preproc_energy_pc2im(w, c) == JEn.preproc_energy_pc2im(_j(w), jc)


def test_calibrate_cim_equal():
    for w in (None, TEn.WORKLOADS["s3dis_4k"]):
        tc, trep = TEn.calibrate_cim(w)
        jc, jrep = JEn.calibrate_cim(None if w is None else _j(w))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert trep == jrep


@pytest.mark.parametrize("scheme", ["bs_cim", "bt_cim", "sc_cim"])
def test_sccim_fom_equal(scheme):
    for scr in (1, 8, 64, 4096):
        assert TEn.sccim_fom(scr, scheme) == JEn.sccim_fom(scr, scheme)


@pytest.mark.parametrize("n_points", [1024, 4096, 16384])
@pytest.mark.parametrize("seg", [False, True])
def test_system_model_equal(n_points, seg):
    assert TEn.pointnet2_macs(n_points, seg) == JEn.pointnet2_macs(n_points, seg)
    assert ([dataclasses.asdict(s) for s in TEn.sa_stage_workloads(n_points)]
            == [dataclasses.asdict(s) for s in JEn.sa_stage_workloads(n_points)])
    tw, jw = TEn.make_pcn_workload(n_points, seg), JEn.make_pcn_workload(n_points, seg)
    assert (tw.name, tw.total_macs, tw.total_fps_iters) == (jw.name, jw.total_macs,
                                                            jw.total_fps_iters)
    tsc = TEn.SystemConstants(tipu_dist_per_cycle=32)
    jsc = JEn.SystemConstants(**dataclasses.asdict(tsc))
    for platform in ("gpu", "pc2im", "baseline2_tipu", "baseline1"):
        assert TEn.system_latency_s(tw, platform) == JEn.system_latency_s(jw, platform)
        assert TEn.system_latency_s(tw, platform, tsc) == JEn.system_latency_s(jw, platform, jsc)
        assert TEn.system_energy_j(tw, platform) == JEn.system_energy_j(jw, platform)
    with pytest.raises(ValueError):
        TEn.system_latency_s(tw, "tpu")


def test_calibrate_system_equal():
    tsc, trep = TEn.calibrate_system()
    jsc, jrep = JEn.calibrate_system()
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)
    assert trep == jrep
    w = TEn.make_pcn_workload(4096, seg=True)
    tsc, trep = TEn.calibrate_system(w)
    jsc, jrep = JEn.calibrate_system(JEn.make_pcn_workload(4096, seg=True))
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)
    assert trep == jrep
