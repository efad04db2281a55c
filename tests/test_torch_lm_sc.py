"""Port parity, dense LM serving under SC W16A16 with float KV caches, and in
bf16: the four dense smoke configs through `make_serve_fns` with every
linear on the SC integer path (the kernel's plain version here), and
stablelm's smoke config in bfloat16, against the JAX package (the harness
is tests/_lm.py; int8 caches under SC are tests/test_torch_lm_sc_int8.py,
float32 and W8A8 tests/test_torch_lm.py: the files split the JAX
references' compile time).

Tolerances and why (the SC ones are tests/_lm.py's constants; measured on
this host's CPU in brackets):
  * SC logits atol 5e-3 [<= 1.7e-3 on logits up to ~3.8]: the integer
    products are exact, but a ~1e-7 float difference upstream (matmul and
    softmax order) can move an activation across a rounding boundary of
    the 16-bit quantizer, one quantum (max|x| / 32767) at a time, and with
    int8 caches a K/V value across one int8 step (max|row| / 127);
  * SC float caches atol 2e-3 [<= 5.0e-4]; int8 cache values within one
    step [<= 1], their scales atol 1e-4 [<= 3.0e-5], for the same reasons;
  * bf16 under SC: logits atol 0.1 [<= 4.7e-2 on logits ~3.1, three bf16
    ulps]: every op rounds its output to 8 bits (an ulp is 1.6e-2 in
    [2, 4)) and XLA's CPU fusions keep float32 inside a fusion where torch
    rounds after each op.  The quantizer itself runs in the input's dtype
    exactly as the reference's: its bf16 integers are bitwise equal
    (`test_bf16_quantization_is_the_references`).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import (
    SC_LOGIT_ATOL,
    assert_logits_close,
    assert_sc_states_close,
    jax_case,
    port_case,
)
from repro.core.quant import quantize_symmetric as j_quantize
from repro.kernels.sc_matmul.ops import sc_quantized_linear as j_sc_linear
from repro_torch.core.quant import quantize_symmetric
from repro_torch.kernels.sc_matmul.ops import sc_quantized_linear
from repro_torch.params import _leaf_to_torch

jax.config.update("jax_platform_name", "cpu")

DENSE = ["stablelm-1.6b", "starcoder2-3b", "gemma3-12b", "command-r-plus-104b"]
BF16_ATOL = 0.1

CASES = [(n, n, "none", None) for n in DENSE] + [("stablelm-bf16", "stablelm-1.6b", "none",
                                                  "bfloat16")]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    """Every case through the reference and the port, once."""
    out = {}
    for cid, name, kv, dtype in CASES:
        ref = jax_case(name, "sc_w16a16", kv=kv, dtype=dtype)
        out[cid] = (ref, port_case(ref))
    return out


@pytest.mark.parametrize("cid", IDS)
def test_prefill_and_decode_logits(runs, cid):
    ref, got = runs[cid]
    assert_logits_close(ref, got, BF16_ATOL if "bf16" in cid else SC_LOGIT_ATOL)


@pytest.mark.parametrize("cid", DENSE)
def test_decode_state_caches(runs, cid):
    assert_sc_states_close(*runs[cid])


def test_bf16_case_runs_in_bf16(runs):
    ref, got = runs["stablelm-bf16"]
    assert all(p.dtype == torch.bfloat16 for p in got["params"].parameters())
    assert got["params"].embed.dtype == torch.bfloat16
    assert ref["tree"]["embed"].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("shape", [(4, 64), (2, 16, 176)])
def test_bf16_quantization_is_the_references(bits, shape):
    """Hazard 2: under bf16 the reference computes the scale, x / scale and the
    round in bf16.  The port does too, so the integers are bitwise equal; a
    float32 quantization of the same values differs in most of them."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x.flat[np.abs(x).argmax()] = np.abs(x).max()  # the largest magnitude positive
    x = x.astype(ml_dtypes.bfloat16)
    got = quantize_symmetric(_leaf_to_torch(x), bits)
    want = j_quantize(jnp.asarray(x), bits)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.scale.dtype == torch.bfloat16
    assert float(got.scale) == float(want.scale)
    f32 = quantize_symmetric(_leaf_to_torch(x).float(), bits)
    assert int((f32.q != got.q).sum()) > got.q.numel() // 20
    if bits == 16:
        # qmax = 32767 is 32768 in bf16, so the scale is max|x| / 2^15 exactly
        # and the largest positive x maps to 2^15, one past the 16-bit range,
        # whose top SC plane is +8 (the CUDA kernel takes it: tests/test_torch_gpu.py)
        assert int(got.q.max()) == 32768


@pytest.mark.parametrize("bits", [16, 8])
def test_bf16_sc_linear_is_the_references(bits):
    """The SC linear on bf16 operands: the exact integer product times the
    product of the two bf16 scales, as float32."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32).astype(ml_dtypes.bfloat16)
    w = (rng.normal(size=(64, 48)) / 8).astype(np.float32).astype(ml_dtypes.bfloat16)
    got = sc_quantized_linear(_leaf_to_torch(x), _leaf_to_torch(w), bits=bits)
    want = np.asarray(j_sc_linear(jnp.asarray(x), jnp.asarray(w), bits=bits))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
