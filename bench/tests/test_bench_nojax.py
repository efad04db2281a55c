"""Nothing the benchmark runs loads JAX or the JAX package; the reference loads no program.

The names are compared whole, by the part before the first dot: the
program's package, `repro_torch`, begins with the JAX package's name,
`repro`, so a prefix test would be wrong both ways.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS_RUN = """
import json, pathlib, sys, tempfile
sys.path[:0] = [{repo!r}, {src!r}]
from bench import devtrace, generator, harness, power, run, work
from bench.reference import pointnet2
from bench.tests import smoke
root = smoke.make_root(pathlib.Path(tempfile.mkdtemp(dir={tmp!r})))
bench = harness.load_benchmark(root)
for m in bench["per_layer"]:
    harness.load_metric(root, m["name"])
for cell in ("cls-sc-b64", "seg-sc-served"):
    assert smoke.run(root, cell, seconds=0.3)["correct"]
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""

REFERENCE_RUN = """
import json, sys
sys.path[:0] = [{repo!r}]
import torch
from bench.reference import pointnet2 as ref
cfg = json.load(open({cfg!r}))
cfg.update(n_points=128, sa=[{{"n_centroids": 32, "radius": 0.3, "nsample": 8, "mlp": [16, 16]}},
                             {{"n_centroids": 8, "radius": 0.6, "nsample": 8, "mlp": [16, 32]}}],
           fp_mlp=[16], head=[16], msp_depth=2)
g = torch.Generator().manual_seed(0)
params = {{k: torch.randn(s, generator=g) for k, s in ref.param_shapes(cfg).items()}}
out = ref.forward(torch.rand(2, 128, 3, generator=g), params, cfg, "sc_w16a16")
assert out.shape == (2, 128, cfg["n_classes"])
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def _top_level_names(code: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax(tmp_path):
    """Every bench module, every metric reader and a run of two cells load no JAX."""
    names = _top_level_names(HARNESS_RUN.format(repo=str(REPO), src=str(REPO / "src"),
                                                tmp=str(tmp_path)))
    assert "repro_torch" in names  # the program under test was loaded, whole-name compare
    assert not names & FORBIDDEN, sorted(names & FORBIDDEN)


def test_reference_loads_no_program(tmp_path):
    """The reference loads neither the program under test nor JAX."""
    names = _top_level_names(REFERENCE_RUN.format(
        repo=str(REPO), cfg=str(REPO / "bench/configs/pointnet2-seg.json")))
    assert "torch" in names
    assert not names & (FORBIDDEN | {"repro_torch"}), sorted(names & (FORBIDDEN | {"repro_torch"}))


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in (REPO / "bench").rglob("*.py")))
def test_no_source_imports_jax(path):
    """No file of the benchmark names JAX or the JAX package in an import."""
    import ast

    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops = {node.module.split(".", 1)[0]}
        else:
            continue
        assert not tops & FORBIDDEN, f"{path}:{node.lineno} imports {sorted(tops & FORBIDDEN)}"
