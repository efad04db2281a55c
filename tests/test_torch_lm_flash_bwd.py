"""Port parity, the flash attention backward and remat: the port's
`flash_attention` gradients (dq, dk, dv) against `jax.vjp` of the JAX
package's `flash_attention` (its `custom_vjp` FA2 backward) on the same
numpy inputs and cotangent, and the three remat modes of the LM stack.

Tolerances and why:
  * float32, each gradient within 1e-5 of its max |g| (measured <= 6.7e-7):
    both accumulate float32 products pair by pair in the same order, but
    the products and the group sums run in other orders (~1e-7 relative);
  * bfloat16, within one bf16 ulp of the gradient's max, 2^-7 of it
    (measured <= 7.1e-4): both round the same float32 accumulations to
    bf16 at the end, and a float32 difference of ~1e-7 can move an
    element across a rounding boundary, by one ulp of that element, which
    is at most 2^-7 of the max;
  * remat none / block / full: bitwise.  Remat decides what the backward
    keeps and what it recomputes, never a value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.kernels import registry
from repro_torch.kernels.sc_matmul import ops as _sc_ops  # noqa: F401  (registers)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.params import named_jax_params

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke shapes gain nothing from intra-op threads, and the suite runs several
    workers on the host's cores: one torch thread a test keeps them from
    oversubscribing (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F32_REL = 1e-5
BF16_REL = 2.0 ** -7
DH = 16
# tests/test_flash_attention.py's CASES (causal, windowed, GQA, non-causal),
# then a block that does not divide the length and a window across blocks
CASES = [
    dict(causal=True, window=None, s=64, sk=64, hq=4, hkv=2, block=16),
    dict(causal=True, window=16, s=64, sk=64, hq=4, hkv=4, block=16),
    dict(causal=True, window=8, s=48, sk=48, hq=2, hkv=1, block=16),
    dict(causal=False, window=None, s=32, sk=48, hq=4, hkv=1, block=16),
    dict(causal=True, window=None, s=96, sk=96, hq=8, hkv=2, block=16),
    dict(causal=True, window=None, s=48, sk=48, hq=4, hkv=2, block=32),
    dict(causal=True, window=12, s=40, sk=40, hq=4, hkv=1, block=16),
]
IDS = [f"c{int(c['causal'])}-w{c['window']}-s{c['s']}x{c['sk']}-h{c['hq']}/{c['hkv']}-b{c['block']}"
       for c in CASES]


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(2, case["s"], case["hq"], DH), (2, case["sk"], case["hkv"], DH),
              (2, case["sk"], case["hkv"], DH), (2, case["s"], case["hq"], DH)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _kw(case):
    return dict(causal=case["causal"], window=case["window"], block=case["block"])


def _jax_grads(case, q, k, v, do):
    _, vjp = jax.vjp(lambda *a: JL.flash_attention(*a, **_kw(case)), q, k, v)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(do)]


def _port_grads(case, q, k, v, do):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = TL.flash_attention(*leaves, **_kw(case))
    grads = torch.autograd.grad(out, leaves, do)
    return out, grads


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_gradients_match_reference(case):
    q, k, v, do = _inputs(case)
    want = _jax_grads(case, *map(jnp.asarray, (q, k, v, do)))
    _, got = _port_grads(case, *map(torch.from_numpy, (q, k, v, do)))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        top = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= F32_REL * top, f"d{name}"


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=[IDS[0], IDS[3]])
def test_flash_gradients_match_reference_in_bf16(case):
    arrays = [jnp.asarray(x).astype(jnp.bfloat16) for x in _inputs(case, seed=1)]
    want = _jax_grads(case, *arrays)
    tensors = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
               for a in arrays]
    out, got = _port_grads(case, *tensors)
    assert out.dtype == torch.bfloat16
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        top = np.abs(w).max()
        assert np.abs(g.float().numpy() - w).max() <= BF16_REL * top, f"d{name}"


def test_flash_saves_only_q_k_v_out_and_lse():
    """The backward's residuals are O(S * Dh): q, k, v, the float32 output and
    the log-sum-exp, and no (q block, kv block) probability tensor; a block as
    long as the sequence would make one (B, H, 64, 64), eight times q's size."""
    case = dict(causal=True, window=None, s=64, sk=64, hq=4, hkv=2, block=64)
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(case))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t,
                                                  lambda t: t):
        TL.flash_attention(q, k, v, **_kw(case))
    assert sorted(saved) == sorted([(2, 4, 64, DH), (2, 2, 64, DH), (2, 2, 64, DH),
                                    (2, 4, 64, DH), (2, 4, 64, 1)])


def test_flash_lse_of_a_row_with_no_key_is_the_floor():
    """A row that sees no key (here a causal window of 0) gets lse = -2e38, and
    the backward's safe lse keeps exp from overflowing: its gradients are 0
    and finite."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    geometry = (True, 0, 16, tuple(TL._block_pairs(4, True, None)), 0.25)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    out, lse = TL._flash_forward(qh, kh, vh, *geometry)
    assert bool((lse == TL._NEG_INF).all()) and bool((out == 0).all())
    grads = TL._flash_backward(do.permute(0, 2, 1, 3), qh, kh, vh, out, lse, *geometry)
    assert all(bool(torch.isfinite(g).all()) and not bool(g.any()) for g in grads)


def _tokens(cfg, seed=1):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def _loss_and_grads(cfg, batch, quant):
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    named = named_jax_params(params)
    loss, _ = T.lm_loss(params, cfg, batch, policy=ExecutionPolicy(quant=quant))
    return loss.detach(), torch.autograd.grad(loss, list(named.values()))


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma3-12b"])
def test_remat_modes_give_bitwise_equal_loss_and_gradients(name, quant):
    base = get_config(name, smoke=True)
    batch = _tokens(base)
    runs = {r: _loss_and_grads(dataclasses.replace(base, remat=r), batch, quant)
            for r in ("none", "block", "full")}
    want_loss, want = runs["none"]
    for r in ("block", "full"):
        loss, got = runs[r]
        assert torch.equal(loss, want_loss), r
        assert all(torch.equal(g, w) for g, w in zip(got, want)), r


class _CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_remat_sets_what_the_backward_recomputes(quant):
    """"block" keeps the linears' 2-D dots, so its backward runs no more of
    them than "none"'s; "full" recomputes each group's forward up to its last
    saved tensor.  The SC matmul (the card's kernel) runs once a linear in the
    forward and, under "full" or "block", once more in the backward's
    recompute: 2 x 7 x n_layers calls a step, the count chip_smoke.py holds."""
    spec = registry.get("sc_matmul")
    calls = []
    registry.register("sc_matmul", plain=lambda *a, **k: calls.append(1) or spec.plain(*a, **k),
                      cuda=spec.cuda)
    try:
        base = get_config("stablelm-1.6b", smoke=True)
        batch = _tokens(base)
        dots, sc = {}, {}
        for r in ("none", "block", "full"):
            cfg = dataclasses.replace(base, remat=r)
            params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
            named = named_jax_params(params)
            calls.clear()
            loss, _ = T.lm_loss(params, cfg, batch, policy=ExecutionPolicy(quant=quant))
            count = _CountDots()
            with count:
                torch.autograd.grad(loss, list(named.values()))
            dots[r], sc[r] = count.n, len(calls)
    finally:
        registry.register("sc_matmul", plain=spec.plain, cuda=spec.cuda)
    per_forward = 7 * base.n_layers if quant != "none" else 0
    assert sc == {"none": per_forward, "block": 2 * per_forward, "full": 2 * per_forward}
    if quant == "none":
        assert dots["block"] == dots["none"] < dots["full"]
