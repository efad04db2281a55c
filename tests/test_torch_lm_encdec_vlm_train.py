"""Port parity, encdec (whisper-small) and vlm (internvl2-2b) training:
`train_loss` and every gradient leaf against the JAX package's jitted
gradient on the smoke configs, with seeded stub frontend outputs (48 encoder
frames a sequence, 8 patches).  Two `make_train_step` steps are
tests/test_torch_lm_encdec_vlm_steps.py; the weight bridge, checkpoints and
the CLI tests/test_torch_lm_encdec_vlm_launch.py (the JAX side's compiles
split over the three files).

The port gets the reference's params through `params.lm_from_jax_params`.
Bounds: tests/_lm.py's (float32 loss 1e-5 and each gradient leaf within
1e-5 of its max [<= 1.3e-6 but for the key biases]; SC the nonzero pattern
and 1e-3 of the leaf's max, 2e-2 on the scale path [<= 6.9e-4]; each step's
loss 1e-4 / 1e-3 and grad_norm rtol 1e-3, in the steps' file).  whisper's attention key biases
(wk.b, every attention) get zero gradient in exact arithmetic, the softmax
cancelling the shift they add to a query's scores: both packages' are
rounding noise [<= 1.1e-9, 2e-8 of the largest gradient], held within
tests/_lm.py's ZERO_GRAD_REL (1e-6) of the tree's largest gradient.
"""

import jax
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import (LOSS_ATOL, assert_grads_close, family_batch, jax_grads, port_grads,
                 zero_grad_leaves)
from repro_torch.configs import get_config

jax.config.update("jax_platform_name", "cpu")

NAMES = ["whisper-small", "internvl2-2b"]
GRAD_CASES = [(n, q) for n in NAMES for q in ("none", "sc_w16a16")]


@pytest.fixture(scope="module")
def grad_refs():
    return {(n, q): jax_grads(n, q, family_batch(get_config(n, smoke=True), 2, 48, seed=1))
            for n, q in GRAD_CASES}


@pytest.mark.parametrize("name,quant", GRAD_CASES)
def test_train_loss_and_gradients_match_reference(grad_refs, name, quant):
    ref = grad_refs[name, quant]
    loss, grads = port_grads(name, quant, ref)
    assert abs(loss - ref["loss"]) <= LOSS_ATOL[quant]
    zero = zero_grad_leaves(ref["tree"])
    # the encoder's, the decoder's self- and cross-attention's, each stacked
    assert len(zero) == (3 if name == "whisper-small" else 0)
    assert_grads_close(grads, ref["grads"], quant, zero=zero)

