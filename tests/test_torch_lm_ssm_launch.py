"""Port parity, ssm (mamba2-1.3b): the weight bridge (byte
for byte both ways), the train state's checkpoints (the port's file is the reference's, byte for
byte, and each package restores the other's) and `python -m
repro_torch.launch.train --arch ... --smoke`, whose checkpoint the reference
reads.
"""

import pathlib

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import assert_bridge_round_trip, assert_checkpoint_bytes, assert_cli_trains

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "mamba2-1.3b"



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_identical(dtype):
    """The reference's ssm tree stacks the L layers in one dict (no list of slots)."""
    assert_bridge_round_trip(NAME, dtype)


def test_checkpoint_is_the_references_byte_for_byte(tmp_path):
    assert_checkpoint_bytes(NAME, tmp_path)


def test_train_cli_runs(tmp_path):
    assert_cli_trains(NAME, ROOT, tmp_path)
