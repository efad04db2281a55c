"""The port's point-cloud examples (examples/torch_*.py) on the CPU, each run
in-process through its `main([...])` with --device cpu on the smoke config
and small counts, as a user runs it:

  * each prints its own check line last and passes it (an example exits 1
    on a failed check, which fails the test);
  * the `core/energy` figures torch_quickstart and torch_preprocess_pipeline
    print equal the JAX package's `repro.core.energy` (the same functions of
    the same workloads: exactly, and as printed);
  * the Chrome trace torch_serve_trace writes parses as JSON with the
    events it counted;
  * without --device each example asks for the card, and on a host without
    one it raises RuntimeError instead of falling back to the CPU.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.core import energy as JE

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "train_pointcloud", "preprocess_pipeline", "serve_runtime",
            "serve_slo", "serve_trace")


def _load(name: str):
    """Import examples/torch_<name>.py as a module (examples/ is not a package)."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, args: list, capsys) -> tuple:
    """main(["--device", "cpu", *args]) of one example: (its return value, its stdout);
    the last line printed must be its passing check."""
    out = _load(name).main(["--device", "cpu", *args])
    text = capsys.readouterr().out
    last = text.strip().splitlines()[-1]
    assert last.startswith("check: ") and last.endswith(": ok"), last
    return out, text


def test_quickstart_trains_and_prints_the_reference_energy_figures(capsys):
    out, text = _run("quickstart", [], capsys)
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
    _, rep = JE.calibrate_cim()
    assert out["reduction_vs_baseline1"] == rep["reduction_vs_baseline1"]
    assert out["reduction_vs_baseline2"] == rep["reduction_vs_baseline2"]
    assert (f"-{rep['reduction_vs_baseline1']*100:.1f}% vs baseline-1 (paper: 97.9%), "
            f"-{rep['reduction_vs_baseline2']*100:.1f}% vs TiPU (paper: 73.4%)") in text
    assert "SC W16A16 inference: logits (16, 8)" in text


def test_train_pointcloud_trains_seg_and_reads_its_checkpoint_back(capsys, tmp_path):
    params, text = _run("train_pointcloud", ["--steps", "3", "--batch", "2", "--log-every", "1",
                                             "--quant", "sc_w16a16", "--ckpt-dir",
                                             str(tmp_path)], capsys)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in text.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert (tmp_path / "step_000000000003").is_dir()
    assert params.head.layers[-1].lin.w.shape[-1] == 8  # seg's per-point classes


def test_preprocess_pipeline_prints_the_reference_energy_split(capsys):
    out, text = _run("preprocess_pipeline", [], capsys)
    b2 = JE.preproc_energy_baseline2(JE.WORKLOADS["semantickitti_16k"])
    assert (out["fps_point"], out["fps_td"]) == (b2["fps_point"], b2["fps_td"])
    tot = b2["fps_point"] + b2["fps_td"]
    assert (f"point reads {b2['fps_point']/tot*100:.0f}%  "
            f"TD update {b2['fps_td']/tot*100:.0f}%") in text
    assert out["kernel_equals_plain"] == {"fps_tiles": None, "lattice_query": None}
    assert text.count("the plain version ran on the CPU; no kernel was compared") == 2
    assert out["msp_utilization"] == 1.0 and out["grid_utilization"] < 1.0


@pytest.mark.parametrize("mix", [False, True], ids=["float", "mix-quant"])
def test_serve_runtime_answers_as_infer(capsys, mix):
    out, _ = _run("serve_runtime", ["--requests", "12", "--replicas", "2",
                                    *(["--mix-quant"] if mix else [])], capsys)
    assert out["responses"] == 12 and out["snapshot"].completed == 12


@pytest.mark.parametrize("kill", [True, False], ids=["kill", "no-kill"])
def test_serve_slo_sheds_bulk_only(capsys, kill):
    out, _ = _run("serve_slo", [] if kill else ["--requests", "60", "--no-kill"], capsys)
    assert out["shed"]["interactive"] == 0
    assert any(ev.action == "rejoin" for ev in out["events"]) == kill


def test_serve_trace_writes_a_chrome_trace_that_parses(capsys, tmp_path):
    path = tmp_path / "trace.json"
    out, _ = _run("serve_trace", ["--requests", "16", "--rate", "400", "--out", str(path)],
                  capsys)
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == out["chrome_events"] > 0
    assert out["problems"] == [] and out["checks"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_device_asks_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the example would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])


def test_serve_trace_nests_the_graph_layers_spans_in_their_batches(capsys, tmp_path,
                                                                   monkeypatch):
    """With the graph layer's replay path on the CPU (stub captures, `_graph_stub`), the
    example prints the graph spans, and its Chrome trace is well formed: each replay of
    a served batch lies inside one of that batch's slices, each part of a replay inside
    the replay, and the card's stage times fill the device lane, preprocessing first."""
    from _graph_stub import stub_graphs
    from repro_torch.core.accelerator import clear_cache

    stub_graphs(monkeypatch)
    path = tmp_path / "trace.json"
    try:
        out, text = _run("serve_trace", ["--requests", "16", "--rate", "400", "--out",
                                         str(path)], capsys)
    finally:
        clear_cache()
    assert out["graph_replays"] > 0 and "graph layer:" in text
    slices = [e for e in json.loads(path.read_text())["traceEvents"] if e["ph"] == "X"]
    batch = {}
    for e in slices:
        if e["pid"] == 2 and not e["name"].startswith("graph"):
            batch.setdefault(e["tid"], []).append(e)
    replays = [e for e in slices if e["pid"] == 2 and e["name"].startswith("graph replay")]
    parts = [e for e in slices if e["pid"] == 2 and e["name"].startswith("graph ")
             and e not in replays and not e["name"].startswith("graph capture")]
    served = [r for r in replays if r["tid"] > 0]
    assert served and len(parts) == 5 * len(replays)

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                               <= outer["ts"] + outer["dur"])

    for r in served:
        assert any(inside(r, b) for b in batch[r["tid"]]), r
    for p in parts:
        assert any(inside(p, r) for r in replays if r["tid"] == p["tid"]), p
    device = [e for e in slices if e["pid"] == 4]
    assert device and {e["name"] for e in device} == {"preprocess", "feature"}
    assert all(e["dur"] > 0 and e["tid"] in batch for e in device if e["tid"] > 0)
