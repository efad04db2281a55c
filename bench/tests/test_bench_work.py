"""The frozen yardsticks, the traffic generator and BENCHMARK.json against the contract."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest

from bench import generator, harness, work
from bench.tests import smoke

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cfg(name):
    return harness.load_config(REPO, BENCH, name)


def test_model_flops_cls_by_hand():
    """pointnet2-cls: 2 x the MACs of SA1 and SA2 a point, the global MLP a centroid, the head."""
    sa1 = 1024 * (3 * 64 + 64 * 64 + 64 * 128)
    sa2 = 256 * (131 * 128 + 128 * 128 + 128 * 256)
    glob = 64 * (259 * 256 + 256 * 512 + 512 * 1024)
    head = 1024 * 512 + 512 * 256 + 256 * 40
    assert work.model_flops_per_cloud(_cfg("pointnet2-cls")) == 2 * (sa1 + sa2 + glob + head)
    assert work.model_flops_per_cloud(_cfg("pointnet2-cls")) == 153_014_272


def test_model_flops_seg_by_hand():
    """pointnet2-seg: the SA MLPs a point, FP0 at 1,024 points, FP1 and the head at 4,096."""
    sa1 = 4096 * (3 * 64 + 64 * 64 + 64 * 128)
    sa2 = 1024 * (131 * 128 + 128 * 128 + 128 * 256)
    fp0 = 1024 * (384 * 256 + 256 * 256)
    fp1 = 4096 * (259 * 128 + 128 * 128)
    head = 4096 * (128 * 128 + 128 * 13)
    assert work.model_flops_per_cloud(_cfg("pointnet2-seg")) == 2 * (sa1 + sa2 + fp0 + fp1 + head)
    assert work.model_flops_per_cloud(_cfg("pointnet2-seg")) == 1_126_432_768


def test_sc_calls_and_launches():
    """A forward makes one SC call a linear, M = batch x the rows of its level."""
    calls = work.sc_calls(_cfg("pointnet2-cls"), 64)
    assert len(calls) == 12
    assert calls[0] == (64 * 1024, 3, 64) and calls[6] == (64 * 64, 259, 256)
    assert calls[-1] == (64, 256, 40)
    assert work.launches_per_forward(_cfg("pointnet2-seg"), "sc_w16a16") == {
        "fps": 2, "lattice": 2, "knn3": 2, "sc_matmul": 12}
    assert work.launches_per_forward(_cfg("pointnet2-cls"), "none")["sc_matmul"] == 0


def test_kernel_least_times():
    """chip_smoke.bound's arithmetic, frozen: FPS and knn3 by operations, SC by the
    logical product."""
    assert work.fps_least_time(32, 256, 64) == pytest.approx(7 * 32 * 256 * 63 / 33.5e12)
    assert work.knn3_least_time(8, 4096, 1024) == pytest.approx(9 * 8 * 4096 * 1024 / 33.5e12)
    m, k, n = 65536, 384, 256
    assert work.sc_least_time(m, k, n) == pytest.approx(
        max((m * k + k * n + m * n) * 4 / 3.35e12, 2 * m * k * n / 1979e12))
    # the lattice query is bound by bytes once its rows stop early
    t, p, kk, ns = 128, 512, 128, 32
    assert work.lattice_least_time(t, p, kk, ns, scanned=t * kk * 40) == pytest.approx(
        (t * kk * 12 + t * p * 12 + t * kk * ns * 5) / 3.35e12)


def test_preproc_least_time_sums_the_forward_calls():
    """A seg forward of 16 clouds: FPS and lattice at MSP depth 3 (8 tiles) for both SA
    stages, and both FP stages' knn3."""
    got = work.preproc_least_time(_cfg("pointnet2-seg"), 16, [100_000, 20_000])
    assert got["fps"] == pytest.approx(work.fps_least_time(128, 512, 128)
                                       + work.fps_least_time(128, 128, 32))
    assert got["lattice"] == pytest.approx(work.lattice_least_time(128, 512, 128, 32, 100_000)
                                           + work.lattice_least_time(128, 128, 32, 32, 20_000))
    assert got["knn3"] == pytest.approx(work.knn3_least_time(16, 1024, 256)
                                        + work.knn3_least_time(16, 4096, 1024))


def test_clouds_are_made_from_the_seed_alone():
    """The same seed gives the same pool; another seed another; sizes stay in range."""
    traffic = harness.load_traffic(REPO, "scenes-sc-served")
    a = generator.make_cloud(traffic, 2**31 + 5, 3, 4096)
    b = generator.make_cloud(traffic, 2**31 + 5, 3, 4096)
    c = generator.make_cloud(traffic, 2**31 + 6, 3, 4096)
    assert a.shape == (4096, 3) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    sizes = generator.cloud_sizes(traffic, 7, 2000)
    assert sizes.min() >= 3000 and sizes.max() <= 6000


@pytest.mark.parametrize("seed", [1, 2**31 + 99])
def test_arrivals_hold_each_phase_count(seed):
    """Every seed sends the same number of requests in each phase of each period."""
    traffic = harness.load_traffic(REPO, "scenes-sc-served")
    due = generator.arrivals(traffic, seed, 20.0, rate=500.0)
    assert len(due) == 10 * (round(500 * 1.5 * 0.4) + round(500 * 0.875 * 1.6))
    burst = ((due % 2.0) < 0.4).sum()
    assert burst == 10 * round(500 * 1.5 * 0.4)
    assert np.all(np.diff(due) >= 0) and due.min() >= 0 and due.max() < 20.0


def test_benchmark_json_keys_and_names():
    """BENCHMARK.json has the contract's keys, names, units and bounds."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"][1] == "bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"] + smoke.SERVED_PER_LAYER])
def test_per_layer_metric_has_its_own_reader(metric):
    """Each per-layer metric's file gives the layer, unit, direction, source and moved
    metric that BENCHMARK.json (or the served cell's entries) gives; each of its cells
    reports the metric it moves."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(smoke.SERVED_CELL)
    bench["end_to_end"].append(smoke.SERVED_END_TO_END)
    bench["per_layer"].extend(smoke.SERVED_PER_LAYER)
    entry = harness.named(bench["per_layer"], metric, "metric")
    mod = harness.load_metric(REPO, metric)
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"], entry["moves"])
    for cell in entry["workloads"]:
        reported = {m["name"] for m in harness.cell_metrics(bench, cell, trace=False)}
        assert entry["moves"] in reported


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_hold_together(cell):
    """Each cell's configuration holds every PointNet2Config field; its mix has its keys;
    it reports setup_s, another end-to-end metric and a per-layer metric."""
    from repro_torch.models.pointnet2 import PointNet2Config

    w = harness.named(BENCH["workloads"], cell, "cell")
    cfg = _cfg(w["config"])
    assert {f.name for f in dataclasses.fields(PointNet2Config)} <= set(cfg)
    assert harness.program_config(cfg).name == w["config"]
    traffic = harness.load_traffic(REPO, w["traffic"])
    assert {"loop", "quant", "batch", "clouds", "limits", "check_batches"} <= set(traffic)
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, trace=True)
