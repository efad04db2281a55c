"""Port parity, encdec (whisper-small) and vlm (internvl2-2b): the weight
bridge (byte for byte both ways), the train state's checkpoints (the port's
file is the reference's, byte for byte, and each package restores the
other's) and `python -m repro_torch.launch.train --arch ... --smoke`, which
feeds the reference's zero stub frontend outputs and leaves a checkpoint the
reference reads.
"""

import pathlib

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import assert_bridge_round_trip, assert_checkpoint_bytes, assert_cli_trains

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ["whisper-small", "internvl2-2b"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_identical(name, dtype):
    """whisper's tree: enc_blocks and dec_blocks each one dict stacked over its
    layers; internvl2's: the dense tree and patch_proj."""
    assert_bridge_round_trip(name, dtype)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_is_the_references_byte_for_byte(name, tmp_path):
    assert_checkpoint_bytes(name, tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_runs(name, tmp_path):
    assert_cli_trains(name, ROOT, tmp_path)
