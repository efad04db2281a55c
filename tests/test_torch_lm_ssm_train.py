"""Port parity, ssm (mamba2-1.3b) training: `train_loss` and every
gradient leaf, and two `make_train_step` steps (warmup_steps=1, so the second runs at lr > 0),
against the JAX package's jitted functions on the smoke config(s).  The
weight bridge, checkpoints and the CLI are
tests/test_torch_lm_ssm_launch.py.

The port gets the reference's params through `params.lm_from_jax_params`.
Bounds: tests/_lm.py's (float32 loss 1e-5 and each gradient leaf within
1e-5 of its max; SC the nonzero pattern and 1e-3 of the leaf's max, 2e-2 on
the scale path; each step's loss 1e-4 / 1e-3 and grad_norm rtol 1e-3).
"""

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import (LOSS_ATOL, assert_grads_close, assert_train_steps_match, jax_grads, port_grads,
                 token_batch)

jax.config.update("jax_platform_name", "cpu")

NAME = "mamba2-1.3b"



GRAD_CASES = [(NAME, "none"), (NAME, "sc_w16a16")]


@pytest.fixture(scope="module")
def grad_refs():
    return {(n, q): jax_grads(n, q, token_batch(256, 2, 48, seed=1)) for n, q in GRAD_CASES}


@pytest.mark.parametrize("name,quant", GRAD_CASES)
def test_train_loss_and_gradients_match_reference(grad_refs, name, quant):
    ref = grad_refs[name, quant]
    loss, grads = port_grads(name, quant, ref)
    assert abs(loss - ref["loss"]) <= LOSS_ATOL[quant]
    assert_grads_close(grads, ref["grads"], quant)


def test_two_train_steps_match_reference():
    assert_train_steps_match(NAME, "none")
