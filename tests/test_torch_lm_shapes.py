"""Port parity, the dry run's abstract inputs (`launch/shapes.py`) against the JAX
package: the cells and their skip reasons, the batches, the decode states
and the parameters at full size as meta tensors (shapes and dtypes leaf for
leaf against `jax.eval_shape`), the AdamW state, and `model_flops` (`==`)
for all 40 (arch, shape) pairs.

Also the meta init: every LM family builds on meta without drawing a
number (`torch.randn` is never called), dbrx-132b's 132 B parameters in
seconds, while a seeded init on the CPU draws what it drew before.
"""

import ast
import functools
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_config as j_get_config
from repro.launch import shapes as JSH
from repro_torch.configs import get_config
from repro_torch.launch import shapes as SH
from repro_torch.launch.dryrun import LM_ARCHS
from repro_torch.models import nn as NN

jax.config.update("jax_platform_name", "cpu")


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(leaf.shape), _dt(leaf)) for p, leaf in flat}


def _pflat(tree, path: str = "") -> dict:
    """{keystr-like path: (shape, dtype)} of a port tree, in `jax.tree_util.keystr`'s form."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        assert tree.is_meta, path
        return {path: (tuple(tree.shape), _dt(tree))}
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _pflat(sub, f"{path}[{k!r}]").items()}
    if hasattr(tree, "_fields"):
        return {p: v for f, sub in zip(tree._fields, tree)
                for p, v in _pflat(sub, f"{path}.{f}").items()}
    return {p: v for i, sub in enumerate(tree) for p, v in _pflat(sub, f"{path}[{i}]").items()}


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return j_get_config(arch), get_config(arch)


CELLS = [(a, s) for a in LM_ARCHS for s in SH.SHAPES]


def _reference_lm_archs() -> list:
    """The reference dry run's LM_ARCHS, read from its source: importing the module
    would set XLA_FLAGS (512 host devices) for this process's children."""
    path = pathlib.Path(JSH.__file__).with_name("dryrun.py")
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "LM_ARCHS":
            return ast.literal_eval(node.value)
    raise AssertionError("no LM_ARCHS in the reference's dryrun.py")


def test_cells_and_skip_reasons():
    assert LM_ARCHS == _reference_lm_archs()
    assert SH.SHAPES == JSH.SHAPES and SH.LONG_OK == JSH.LONG_OK
    for arch, shape in CELLS:
        assert SH.skip_reason(arch, shape) == JSH.skip_reason(arch, shape)
    assert sum(SH.skip_reason(a, s) is not None for a, s in CELLS) == 7


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_and_model_flops(arch):
    jcfg, cfg = _cfgs(arch)
    for shape in SH.SHAPES:
        assert _pflat(SH.input_specs(cfg, shape)) == _jflat(JSH.input_specs(jcfg, shape)), shape
        assert SH.model_flops(cfg, shape) == JSH.model_flops(jcfg, shape), shape
    assert _pflat(SH.token_batch_specs(cfg, 3, 5, labels=False)) == _jflat(
        JSH.token_batch_specs(jcfg, 3, 5, labels=False))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_params_and_states_equal_eval_shape(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = JSH.abstract_params(jcfg)
    params = SH.abstract_params(cfg)
    assert _pflat(params) == _jflat(jparams)
    assert _pflat(SH.abstract_opt_state(params)) == _jflat(
        jax.eval_shape(lambda: JSH.adamw_init_from_shapes(jparams)))
    for shape, info in SH.SHAPES.items():
        if info["kind"] == "decode":
            assert _pflat(SH.decode_state_specs(cfg, shape)) == _jflat(
                JSH.decode_state_specs(jcfg, shape)), shape


def test_meta_init_draws_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.randn called while building on meta")

    monkeypatch.setattr(torch, "randn", refuse)
    for arch in LM_ARCHS:
        params = SH.abstract_params(get_config(arch))
        leaves = _pflat(params)
        assert leaves and all(isinstance(v, tuple) for v in leaves.values())
    t0 = time.perf_counter()
    SH.abstract_params(get_config("dbrx-132b"))
    assert time.perf_counter() - t0 < 10.0


def test_cpu_draws_unchanged():
    # the seeded draws on the CPU: the generator's stream, as before
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = NN.draw_normal(5, 7, generator=g1, device="cpu")
    b = torch.randn(5, 7, generator=g2)
    assert torch.equal(a, b)
    lin = NN.Linear(4, 6, generator=torch.Generator().manual_seed(1), device="cpu")
    want = torch.randn(4, 6, generator=torch.Generator().manual_seed(1)) * (1.0 / np.sqrt(4))
    assert torch.equal(lin.w.detach(), want.to(torch.float32))
    m = NN.Linear(4, 6, device="meta")
    assert m.w.is_meta and m.w.shape == (4, 6)
