"""The benchmark's cells and the float cell's control on the card, at smoke sizes.

Marked gpu: each test skips inside its body where there is no card (run on
the card: python -m pytest -q -m gpu bench/tests/test_bench_gpu.py).
"""

from __future__ import annotations

import json

import pytest
import torch

from bench import harness, power
from bench.tests import smoke


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench_root_gpu"))


def _card_env():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    card = power.card_id(torch.cuda.get_device_properties(dev))
    return harness.Env(torch, dev, power=lambda: power.PowerSampler(card),
                       kind=torch.cuda.get_device_name(dev), platform="gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(smoke.CELLS))
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_cell_on_the_card(root, cell, trace):
    """Each cell runs on the card, checks out correct, and its traced run reads the trace."""
    env = _card_env()
    out = harness.run_cell(cell, smoke.SEED, 1.5, trace, env=env, root=root)
    got = json.loads(harness.result_line(out)[0])
    assert got["correct"] is True, got["checks"]
    assert got["device"]["platform"] == "gpu"
    if trace:
        assert 0 < got["device"]["busy_s"] <= got["device"]["window_s"]


@pytest.mark.gpu
def test_tf32_control_of_the_float_cell_is_not_correct(root):
    """The float cell's control, its matmuls in TF32, fails the check."""
    env = _card_env()
    try:
        out = harness.run_cell("cls-fp32-b64", smoke.SEED, 1.0, False, env=env, root=root,
                               tf32=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert out["correct"] is False
