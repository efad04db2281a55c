"""Port parity, encdec (whisper-small) and vlm (internvl2-2b): two
`make_train_step` steps against the reference's jitted step on the smoke
configs (warmup_steps=1, so the second runs at lr > 0; tests/_lm.py's
bounds: each step's loss within 1e-4, lr equal, grad_norm rtol 1e-3), with
seeded stub frontend outputs of 32 encoder frames or 8 patches a sequence.
"""

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import assert_train_steps_match

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("name", ["whisper-small", "internvl2-2b"])
def test_two_train_steps_match_reference(name):
    assert_train_steps_match(name, "none")
