"""Port parity, hybrid (recurrentgemma-2b): two `make_train_step` steps
against the reference's jitted step (warmup_steps=1, so the second runs at
lr > 0; tests/_lm.py's bounds), the weight bridge (byte for byte both
ways), the train state's checkpoints (the port's file is the reference's, byte for
byte, and each package restores the other's) and `python -m
repro_torch.launch.train --arch ... --smoke`, whose checkpoint the reference
reads.
"""

import pathlib

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import (assert_bridge_round_trip, assert_checkpoint_bytes, assert_cli_trains,
                 assert_train_steps_match)

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "recurrentgemma-2b"



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_identical(dtype):
    """The reference's hybrid tree: one stacked tree a slot, unstacked "rem" layers."""
    assert_bridge_round_trip(NAME, dtype)


def test_checkpoint_is_the_references_byte_for_byte(tmp_path):
    assert_checkpoint_bytes(NAME, tmp_path)


def test_train_cli_runs(tmp_path):
    assert_cli_trains(NAME, ROOT, tmp_path)


def test_two_train_steps_match_reference():
    assert_train_steps_match(NAME, "none")
