"""Port parity, hybrid (recurrentgemma-2b) training: `train_loss` and every
gradient leaf against the JAX package's jitted gradient on the smoke config.
Two train steps, the weight bridge, checkpoints and the CLI are
tests/test_torch_lm_hybrid_launch.py (the JAX side's compiles split over
the two files).

The port gets the reference's params through `params.lm_from_jax_params`.
Bounds: tests/_lm.py's (float32 loss 1e-5 and each gradient leaf within
1e-5 of its max; SC the nonzero pattern and 1e-3 of the leaf's max, 2e-2 on
the scale path; each step's loss 1e-4 / 1e-3 and grad_norm rtol 1e-3),
but for one: the float gradients here are held within 2e-5 of each leaf's
max [<= 1.26e-5], not 1e-5.  One RG-LRU block's gradients agree within
4.0e-6; the reference's own jitted and eager gradients differ by 2.9e-6;
the scan's association order is not the cause (a port of
`jax.lax.associative_scan`'s order, bitwise on the scan, still gave
1.25e-5).  Through the five layers the gates' exp and log-sigmoid, whose
float32 results part from XLA's by an ulp, feed a = exp(8 r log
sigmoid(lam)) and sqrt(1 - a^2), which amplify them as a approaches 1
(lam puts a at 0.9-0.999).
"""

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import LOSS_ATOL, assert_grads_close, jax_grads, port_grads, token_batch

jax.config.update("jax_platform_name", "cpu")

NAME = "recurrentgemma-2b"
FLOAT_GRAD_REL = 2e-5



GRAD_CASES = [(NAME, "none"), (NAME, "sc_w16a16")]


@pytest.fixture(scope="module")
def grad_refs():
    return {(n, q): jax_grads(n, q, token_batch(256, 2, 48, seed=1)) for n, q in GRAD_CASES}


@pytest.mark.parametrize("name,quant", GRAD_CASES)
def test_train_loss_and_gradients_match_reference(grad_refs, name, quant):
    ref = grad_refs[name, quant]
    loss, grads = port_grads(name, quant, ref)
    assert abs(loss - ref["loss"]) <= LOSS_ATOL[quant]
    assert_grads_close(grads, ref["grads"], quant, float_rel=FLOAT_GRAD_REL)

