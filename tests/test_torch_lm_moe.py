"""Port parity, the moe family (granite-moe-3b-a800m, dbrx-132b): `models/moe.py`
against the reference's `moe_apply` and `moe_aux_loss`, then each smoke config
through `make_serve_fns`, the configs and the family API.  Training, the
weight bridge, checkpoints and the CLI are tests/test_torch_lm_moe_train.py
(the two files split the JAX references' compile time).

The reference runs jitted, once per case (module-scoped fixtures); the port
gets its params through `params.lm_from_jax_params`.

Tolerances and why (measured on this host's CPU in brackets):
  * moe_apply, atol 1e-5 [<= 3.6e-7 in float32, W16A16 and W8A8, tied and
    overflowing routers included]: the routing is the same (the same
    probabilities, ties to the lower expert; under SC the router's logits
    are the same integer sums times the same scales), and the expert
    products sum in other orders;
  * serving: float32 and W8A8 logits atol 1e-5 [<= 2.4e-6], float caches
    1e-5 [<= 1.7e-6], int8 caches bitwise, generate's tokens equal; W16A16
    logits within tests/_lm.py's SC bound, 5e-3 [<= 1.5e-4], its caches
    within SC_CACHE_ATOL, 2e-3 [<= 1.7e-4].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import (SC_LOGIT_ATOL, assert_logits_close, assert_sc_states_close, jax_case, max_diff,
                 port_case)
from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import families
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

NAMES = ["granite-moe-3b-a800m", "dbrx-132b"]
MOE_ATOL = 1e-5
FLOAT_ATOL = 1e-5



# -- moe_apply and moe_aux_loss ----------------------------------------------------


def _moe_pair(name: str, seed: int = 0):
    """(reference config, its moe params, port config, an MoE holding them)."""
    jcfg, cfg = j_get_config(name, smoke=True), get_config(name, smoke=True)
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    module = M.MoE(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        module.router.w.copy_(torch.from_numpy(np.asarray(jp["router"]["w"])))
        for k in ("wi", "wg", "wo"):
            getattr(module, k).copy_(torch.from_numpy(np.asarray(jp[k])))
    return jcfg, jp, cfg, module


def _x(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _both(name, x, quant, edit=None):
    """moe_apply of x in both packages, after edit(jax params, module) if given."""
    jcfg, jp, cfg, module = _moe_pair(name)
    if edit is not None:
        jp = edit(jp, module)
    pol = ExecutionPolicy(quant=quant)
    want = jax.jit(lambda p, v: JM.moe_apply(p, jcfg, v, policy=JPolicy(quant=quant)))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got = M.moe_apply(module, cfg, torch.from_numpy(x), policy=pol)
    return np.asarray(want), got.numpy(), cfg, module


@pytest.mark.parametrize("quant", ["none", "sc_w16a16", "sc_w8a8"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_matches_reference(name, quant):
    want, got, _, _ = _both(name, _x(get_config(name, smoke=True), 2, 12, seed=1), quant)
    assert got.shape == want.shape == (2, 12, 64)
    assert max_diff(got, want) <= MOE_ATOL


def _tie_router(jp, module):
    """Router columns 1, 2 and 3 equal and the largest for positive inputs: every
    token's logits tie among experts 1-3."""
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 1:4] = 1.0
    w[:, 0] = 0.5
    w[:, 4:] = -1.0
    with torch.no_grad():
        module.router.w.copy_(torch.from_numpy(w))
    return dict(jp, router={"w": jnp.asarray(w)})


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_tied_router_logits_pick_the_lower_expert(quant):
    """granite smoke (top-2 of 8): experts 1, 2 and 3 tie on every token, and both
    packages take 1 and 2, as jax.lax.top_k does; the outputs then agree."""
    name = "granite-moe-3b-a800m"
    x = np.abs(_x(get_config(name, smoke=True), 2, 8, seed=2))
    want, got, cfg, module = _both(name, x, quant, edit=_tie_router)
    assert max_diff(got, want) <= MOE_ATOL
    with torch.no_grad():
        logits = M.router_logits(module.router, torch.from_numpy(x),
                                 ExecutionPolicy(quant=quant))
    assert bool((logits[..., 1] == logits[..., 2]).all() & (logits[..., 2] == logits[..., 3]).all())
    buf_row, _, _, keep = M.route(cfg, logits)
    picks = torch.where(keep, buf_row, -1).reshape(2, 8, cfg.top_k)
    kept = picks[picks >= 0]
    assert set(kept.tolist()) == {1, 2}
    probs = jax.nn.softmax(jnp.asarray(logits.numpy()), axis=-1)
    assert np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).tolist() == [[[1, 2]] * 8] * 2


def test_tie_order_is_jax_top_k_on_a_three_way_tie():
    """Over [0.1, 0.3, 0.3, 0.3, 0.0] with k = 2, jax.lax.top_k gives [1, 2]; so
    does the port's route (a stable descending sort)."""
    p = np.array([[[0.1, 0.3, 0.3, 0.3, 0.0]]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(p), 2)[1])
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True), n_experts=5,
                              top_k=2, capacity_factor=10.0)
    buf_row, _, _, _ = M.route(cfg, torch.log(torch.from_numpy(p)))
    assert want.tolist() == [[[1, 2]]] and buf_row.tolist() == [[1, 2]]


def _one_expert_router(jp, module):
    """Expert 0 first for every positive input, past its capacity."""
    w = -np.ones_like(np.asarray(jp["router"]["w"]))
    w[:, 0] = 1.0
    w[:, 1] = 0.0
    with torch.no_grad():
        module.router.w.copy_(torch.from_numpy(w))
    return dict(jp, router={"w": jnp.asarray(w)})


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_a_batch_routed_to_one_expert_drops_past_capacity(quant):
    """Every token picks experts 0 and 1; with 12 tokens their capacity of
    round(12 * 2 / 8 * 1.25) = 4 keeps the first 4 tokens of each row and
    drops the rest (their weight is lost), as the reference does."""
    name = "granite-moe-3b-a800m"
    x = np.abs(_x(get_config(name, smoke=True), 2, 12, seed=3))
    want, got, cfg, module = _both(name, x, quant, edit=_one_expert_router)
    assert max_diff(got, want) <= MOE_ATOL
    assert M.capacity(cfg, 12) == 4
    with torch.no_grad():
        logits = M.router_logits(module.router, torch.from_numpy(x), ExecutionPolicy(quant=quant))
    buf_row, buf_col, _, keep = M.route(cfg, logits)
    rows = buf_row.reshape(2, 12, 2)
    for slot in (0, 1):  # expert 0, then expert 1, for every token
        assert rows[:, :4, slot].tolist() == [[slot] * 4] * 2
        assert rows[:, 4:, slot].tolist() == [[8] * 8] * 2  # dropped: scratch row E = 8
    assert buf_col.reshape(2, 12, 2)[:, :4, 0].tolist() == [[0, 1, 2, 3]] * 2
    assert int((~keep).sum()) == 32


def test_capacity_rounds_half_to_even():
    """granite smoke, 8 tokens: 8 * 2 / 8 * 1.25 = 2.5 rounds to 2 (Python's round)."""
    jcfg, cfg = j_get_config("granite-moe-3b-a800m", smoke=True), get_config(
        "granite-moe-3b-a800m", smoke=True)
    for s in (1, 3, 8, 12, 16, 17):
        want = int(max(1, round(s * jcfg.top_k / jcfg.n_experts * jcfg.capacity_factor)))
        assert M.capacity(cfg, s) == want
    assert M.capacity(cfg, 8) == 2


@pytest.mark.parametrize("name", NAMES)
def test_moe_aux_loss_matches_reference(name):
    jcfg, jp, cfg, module = _moe_pair(name)
    x = _x(cfg, 2, 12, seed=4)
    want = float(JM.moe_aux_loss(jp, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = M.moe_aux_loss(module, cfg, torch.from_numpy(x))
    assert got.shape == () and abs(float(got) - want) <= 1e-6


# -- serving through make_serve_fns --------------------------------------------------

# (id, config, quant, kv)
CASES = [
    ("granite-none", "granite-moe-3b-a800m", "none", "none"),
    ("granite-none-int8", "granite-moe-3b-a800m", "none", "int8"),
    ("granite-w16a16", "granite-moe-3b-a800m", "sc_w16a16", "none"),
    ("granite-w8a8-int8", "granite-moe-3b-a800m", "sc_w8a8", "int8"),
    ("dbrx-none", "dbrx-132b", "none", "none"),
    ("dbrx-w16a16", "dbrx-132b", "sc_w16a16", "none"),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for cid, name, quant, kv in CASES:
        ref = jax_case(name, quant, kv=kv)
        out[cid] = (ref, port_case(ref))
    return out


@pytest.mark.parametrize("cid", IDS)
def test_serving_logits(runs, cid):
    ref, got = runs[cid]
    assert got["prefill"].shape == (2, 1, got["cfg"].vocab_size)
    assert_logits_close(ref, got, SC_LOGIT_ATOL if ref["quant"] == "sc_w16a16" else FLOAT_ATOL)


@pytest.mark.parametrize("cid", IDS)
def test_serving_caches(runs, cid):
    """Float caches within the logits' bound, int8 values bitwise, cache_len equal."""
    ref, got = runs[cid]
    if ref["quant"] == "sc_w16a16":
        assert_sc_states_close(ref, got)
        return
    for g_state, w_state in zip([got["state0"], *got["states"]], [ref["state0"], *ref["states"]]):
        for gs, ws in zip(g_state, w_state):
            for g, w in zip(gs, ws):
                assert g.shape == w.shape
                if g.dtype == np.int32 and g.ndim:
                    np.testing.assert_array_equal(g, w)
                else:
                    assert max_diff(g, w) <= (1e-7 if g.ndim and g.shape[-1] == 1 else FLOAT_ATOL)


@pytest.mark.parametrize("cid", [c for c in IDS if "w16a16" not in c])
def test_generate_tokens_equal(runs, cid):
    ref, got = runs[cid]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))


def test_moe_blocks_and_caches(runs):
    """The moe family is the transformer with an MoE for each block's MLP; its
    caches are the dense ones (int8 under kv_quant)."""
    _, got = runs["granite-none-int8"]
    params = got["params"]
    assert isinstance(params, T.DenseLM)
    assert all(isinstance(b.mlp, M.MoE) for b in params.blocks)
    assert params.blocks[0].mlp.router.w.dtype == torch.float32
    assert params.blocks[0].mlp.wi.shape == (8, 64, 32)


# -- configs and the family API -------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal(name, smoke):
    mine, ref = get_config(name, smoke=smoke), j_get_config(name, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


def test_family_api_is_the_transformers():
    api = families.get_family_api(get_config("dbrx-132b", smoke=True))
    assert api["init"] is T.init_lm and api["train_loss"] is T.lm_loss
    assert api["init_decode_state"] is T.init_decode_state


