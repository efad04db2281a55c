"""The port as a package: it imports neither jax nor the JAX package, every
public name carries a docstring (ruff's pydocstyle rules cover src/repro_torch),
and chip_smoke.py refuses to report anything without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.core.accelerator" in mods and "repro_torch.params" in mods
    assert {"repro_torch.data.pointclouds", "repro_torch.optim.adamw",
            "repro_torch.optim.schedule", "repro_torch.checkpoint.store",
            "repro_torch.launch.train", "repro_torch.core.energy",
            "repro_torch.configs.base", "repro_torch.configs.stablelm_1_6b",
            "repro_torch.configs.gemma3_12b", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.models.families",
            "repro_torch.serve.step", "repro_torch.train.step",
            "repro_torch.data.tokens", "repro_torch.models.moe", "repro_torch.models.mamba2",
            "repro_torch.models.rglru", "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.dbrx_132b", "repro_torch.configs.mamba2_1_3b",
            "repro_torch.configs.recurrentgemma_2b", "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis", "repro_torch.launch.shapes",
            "repro_torch.launch.mesh", "repro_torch.sharding.policy",
            "repro_torch.sharding.hints", "repro_torch.sharding.spec",
            "repro_torch.core.accounting"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_names_jax_or_repro():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {p.name for p in examples} >= {
        "torch_serve_lm.py", "torch_quickstart.py", "torch_train_pointcloud.py",
        "torch_preprocess_pipeline.py", "torch_serve_runtime.py", "torch_serve_slo.py",
        "torch_serve_trace.py"}
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
                 *examples]:
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}, path


def _has_doc(node) -> bool:
    return (
        bool(node.body)
        and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
        and isinstance(node.body[0].value.value, str)
        and bool(node.body[0].value.value.strip())
    )


def test_public_names_have_docstrings():
    missing = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        rel = path.relative_to(ROOT)
        if not _has_doc(tree):
            missing.append(f"{rel}: module")
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                if not _has_doc(node):
                    missing.append(f"{rel}:{node.lineno} class {node.name}")
                for item in node.body:
                    if (isinstance(item, ast.FunctionDef) and not item.name.startswith("_")
                            and not _has_doc(item)):
                        missing.append(f"{rel}:{item.lineno} {node.name}.{item.name}")
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                if not _has_doc(node):
                    missing.append(f"{rel}:{node.lineno} {node.name}")
    assert missing == [], "\n".join(missing)


def _run_smoke(cwd: pathlib.Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run for real")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "torch.cuda.is_available() is false" in out.stderr
    # alone in a directory, without the package beside it, it fails as well
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
