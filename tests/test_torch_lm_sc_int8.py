"""Port parity, dense LM serving under SC W16A16 with int8 KV caches: the four
dense smoke configs through `make_serve_fns` (every linear on the SC
integer path, the kernel's plain version here) against the JAX package.
The harness is tests/_lm.py, the tolerances and their reasons are
tests/test_torch_lm_sc.py's (the files split the JAX references' compile
time).
"""

import jax
import numpy as np
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import SC_LOGIT_ATOL, assert_logits_close, assert_sc_states_close, jax_case, port_case

jax.config.update("jax_platform_name", "cpu")

DENSE = ["stablelm-1.6b", "starcoder2-3b", "gemma3-12b", "command-r-plus-104b"]


@pytest.fixture(scope="module")
def runs():
    """Every config through the reference and the port, once."""
    out = {}
    for name in DENSE:
        ref = jax_case(name, "sc_w16a16", kv="int8")
        out[name] = (ref, port_case(ref))
    return out


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_logits(runs, name):
    assert_logits_close(*runs[name], SC_LOGIT_ATOL)


@pytest.mark.parametrize("name", DENSE)
def test_decode_state_caches(runs, name):
    """int8 values within one step, scales and cache_len as stated."""
    ref, got = runs[name]
    assert_sc_states_close(ref, got)
    assert got["state0"][0][0].dtype == np.int32  # the int8 values, compared as int32


@pytest.mark.parametrize("name", DENSE)
def test_generate_tokens_equal(runs, name):
    """At these widths the greedy tokens under SC match the reference's too."""
    ref, got = runs[name]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))
