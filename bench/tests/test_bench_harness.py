"""The harness end to end on the CPU at smoke sizes: result line, added files, faults, control."""

from __future__ import annotations

import concurrent.futures
import json

import pytest

from bench.tests import smoke

END_TO_END = {"seg-sc-b16": {"clouds_per_s", "mj_per_cloud", "setup_s"},
              "cls-sc-b64": {"clouds_per_s", "mj_per_cloud", "setup_s"},
              "cls-fp32-b64": {"clouds_per_s", "mj_per_cloud", "setup_s"},
              "seg-sc-served": {"latency_p95_ms", "setup_s"}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench_root"))


@pytest.mark.parametrize("cell", sorted(END_TO_END))
def test_cell_result_line(root, cell):
    """Every cell runs, checks out correct, and prints the contract's keys, checks last."""
    got = smoke.run(root, cell)
    assert list(got) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert got["correct"] is True, got["checks"]
    assert got["failed"] == 0 and got["attempted"] > 0
    assert set(got["metrics"]) == END_TO_END[cell]
    assert all(m["value"] > 0 for m in got["metrics"].values())
    assert got["checks"]["logit_gap"]["value"] <= got["checks"]["logit_gap"]["limit"]
    assert set(got["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_served_run_reads_the_runtime_spans(root):
    """A --trace 1 run of the served cell reads its per-layer metrics from the runtime's trace."""
    got = smoke.run(root, "seg-sc-served", trace=True)
    assert got["correct"] is True
    assert {"queue_ms.served", "occupancy.served", "execute_ms.served"} <= set(got["metrics"])
    assert 0 < got["metrics"]["occupancy.served"]["value"] <= 100
    assert "breakdown" in got and got["device"]["window_s"] > 0


def test_new_cell_config_and_metric_from_added_files_alone(root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files, and
    entries added to BENCHMARK.json, make a cell that runs: no file is edited."""
    new = smoke.make_root(tmp_path)
    cfg = json.loads((new / "bench/configs/pointnet2-cls-smoke.json").read_text())
    cfg.update(name="pointnet2-cls-wide", n_classes=10, head=[96])
    (new / "bench/configs/pointnet2-cls-wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((new / "bench/traffic/objects-sc-b64-smoke.json").read_text())
    traffic.update(batch=3, check_min_answers=3)
    (new / "bench/traffic/objects-sc-b3.json").write_text(json.dumps(traffic))
    (new / "bench/metrics/clouds_seen.batch.py").write_text(
        '"""Clouds the window completed."""\n\ndef read(run):\n    return float(run.clouds)\n')
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pointnet2-cls-wide", "source": "test",
                             "file": "bench/configs/pointnet2-cls-wide.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "cls-wide-b3", "config": "pointnet2-cls-wide",
                               "traffic": "objects-sc-b3", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cls-sc-b64" in m["workloads"]:
            m["workloads"].append("cls-wide-b3")
    bench["per_layer"].append({"name": "clouds_seen.batch", "unit": "clouds", "better": "higher",
                               "source": "host_clock", "layer": "entry point and graphs",
                               "moves": "clouds_per_s", "workloads": ["cls-wide-b3"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    got = smoke.run(new, "cls-wide-b3")
    assert got["correct"] is True
    assert got["attempted"] % 3 == 0
    assert {"clouds_per_s", "mj_per_cloud", "setup_s"} == set(got["metrics"])
    traced = smoke.run(new, "cls-wide-b3", trace=True)
    assert traced["metrics"]["clouds_seen.batch"]["value"] > 0


def _alter_one_answer(logits):
    out = logits.clone()
    out.view(-1)[0] += 1.0
    return out


def _drop_half_the_batch(logits):
    out = logits.clone()
    half = out.shape[0] // 2
    out[half:] = out[:half].mean(dim=0, keepdim=True)
    return out


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch],
                         ids=["answer_altered", "half_the_batch_left_out"])
@pytest.mark.parametrize("cell", ["seg-sc-b16", "cls-fp32-b64"])
def test_broken_timed_path_is_not_correct(root, cell, fault):
    """The check fails a run whose timed path alters an answer or leaves half the batch out."""
    got = smoke.run(root, cell, fault=fault)
    assert got["correct"] is False
    assert got["checks"]["logit_gap"]["value"] > got["checks"]["logit_gap"]["limit"]


def test_served_answer_altered_is_not_correct(root):
    """An answer altered where the runtime produces it fails the served cell's check."""
    def fault(rt):
        dispatch = rt.scheduler.dispatch_fn

        def altered(mb):
            inner, outer = dispatch(mb), concurrent.futures.Future()

            def done(f):
                if f.exception() is not None:
                    outer.set_exception(f.exception())
                else:
                    out = f.result().copy()
                    out.reshape(-1)[0] += 1.0
                    outer.set_result(out)
            inner.add_done_callback(done)
            return outer
        rt.scheduler.dispatch_fn = altered

    got = smoke.run(root, "seg-sc-served", fault=fault)
    assert got["correct"] is False


@pytest.mark.parametrize("cell", ["seg-sc-b16", "cls-sc-b64", "seg-sc-served"])
def test_w8a8_control_is_not_correct(root, cell):
    """The control of an SC W16A16 cell, the program's own W8A8 path, fails the check."""
    got = smoke.run(root, cell, quant="sc_w8a8")
    assert got["correct"] is False
    assert got["checks"]["logit_gap"]["value"] > got["checks"]["logit_gap"]["limit"]
