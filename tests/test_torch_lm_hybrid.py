"""Port parity, the hybrid family (recurrentgemma-2b): `models/rglru.py` against
the reference's `_lru_scan` and `rglru_apply` (train and decode), then the
smoke config (one group of recurrent, recurrent, local and two remainder
recurrent layers) through `make_serve_fns`, the config, the geometry and
the family API.  Training, the weight bridge, checkpoints and the CLI are
tests/test_torch_lm_hybrid_train.py (the two files split the JAX
references' compile time).

The reference runs jitted, once per case; the port gets its params through
`params.lm_from_jax_params`.

Tolerances and why (measured on this host's CPU in brackets):
  * `lru_scan` atol 1e-5 against `jax.lax.associative_scan` [<= 4.8e-7]
    and against the sequential loop of tests/test_ssm_recurrences.py
    [<= 2.9e-7]: the same recurrence, associated in another order
    (Hillis-Steele here);
  * `rglru_apply` (out, state, conv history) atol 1e-5 [<= 3.7e-7 float,
    1.3e-7 W16A16]; serving logits in float32 and W8A8 atol 1e-5
    [<= 2.2e-6]; their states, values up to ~3.5, within 3e-5 [<= 1.2e-5]:
    the remainder layers' conv inputs carry five layers' float32
    differences; W16A16 logits within tests/_lm.py's SC bound, 5e-3
    [<= 1.7e-4], states within SC_STATE_ATOL, 2e-3 [<= 6.9e-4];
  * generate's tokens equal in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import SC_LOGIT_ATOL, assert_logits_close, jax_case, max_diff, port_case, state_arrays
from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import families as JF
from repro.models import rglru as JR
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import families
from repro_torch.models import rglru as R

jax.config.update("jax_platform_name", "cpu")

NAME = "recurrentgemma-2b"
SCAN_ATOL = 1e-5
FLOAT_ATOL = 1e-5
FLOAT_STATE_ATOL = 3e-5
SC_STATE_ATOL = 2e-3



def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- the scan and the recurrent block ------------------------------------------------


@pytest.mark.parametrize("s", [1, 7, 24, 33])
def test_lru_scan_matches_reference_and_the_loop(s):
    rng = np.random.default_rng(s)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, s, 8))))).astype(np.float32)
    x = rng.standard_normal((2, s, 8)).astype(np.float32)
    want = np.asarray(JR._lru_scan(jnp.asarray(x), jnp.asarray(a)))
    got = R.lru_scan(_t(x), _t(a))
    assert got.shape == (2, s, 8)
    assert max_diff(got, want) <= SCAN_ATOL
    h, loop = np.zeros((2, 8)), np.zeros((2, s, 8))
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        loop[:, t] = h
    assert max_diff(got, loop) <= SCAN_ATOL


def _block_pair(seed: int = 0):
    """(reference config, its RG-LRU params, port config, an RGLRU holding them)."""
    jcfg, cfg = j_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    jp = JR.rglru_init(jax.random.PRNGKey(seed), jcfg)
    module = R.RGLRU(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = jp
            for part in name.split("."):
                node = node[part]
            p.copy_(_t(node))
    return jcfg, jp, cfg, module


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
@pytest.mark.parametrize("s", [2, 12])
def test_rglru_apply_train_and_decode_match_reference(quant, s):
    """A prefill of s tokens (2 is shorter than the conv's history), then two
    decode steps from its cache."""
    jcfg, jp, cfg, module = _block_pair()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    steps = [rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) for _ in range(2)]
    jpol, pol = JPolicy(quant=quant), ExecutionPolicy(quant=quant)
    atol = FLOAT_ATOL if quant == "none" else SC_STATE_ATOL
    fwd = jax.jit(lambda p, v: JR.rglru_apply(p, jcfg, v, policy=jpol))
    dec = jax.jit(lambda p, v, c: JR.rglru_apply(p, jcfg, v, cache=c, policy=jpol))
    out_w, cache_w = fwd(jp, jnp.asarray(x))
    with torch.no_grad():
        out, cache = R.rglru_apply(module, cfg, _t(x), policy=pol)
        assert cache.h.dtype == torch.float32 and cache.conv.shape == (2, 3, cfg.lru_width)
        for v in [None, *steps]:
            if v is not None:
                out_w, cache_w = dec(jp, jnp.asarray(v), cache_w)
                out, cache = R.rglru_apply(module, cfg, _t(v), cache=cache, policy=pol)
            assert max_diff(out, np.asarray(out_w)) <= atol
            assert max_diff(cache.h, np.asarray(cache_w.h)) <= atol
            assert max_diff(cache.conv, np.asarray(cache_w.conv)) <= atol


# -- serving through make_serve_fns --------------------------------------------------

# (id, quant, extra jax_case arguments): a prompt of 12 is past the smoke
# window of 8, so prefill keeps the local caches' last 8 entries rolled by 4
CASES = [("none", "none", {"prompt": 12, "s_max": 20}),
         ("w16a16", "sc_w16a16", {"prompt": 12, "s_max": 20}),
         ("w8a8", "sc_w8a8", {"prompt": 12, "s_max": 20}),
         ("within-window", "none", {"prompt": 5, "s_max": 12})]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for cid, quant, extra in CASES:
        ref = jax_case(NAME, quant, **extra)
        out[cid] = (ref, port_case(ref))
    return out


@pytest.mark.parametrize("cid", IDS)
def test_serving_logits(runs, cid):
    ref, got = runs[cid]
    assert got["prefill"].shape == (2, 1, got["cfg"].vocab_size)
    assert_logits_close(ref, got, SC_LOGIT_ATOL if ref["quant"] == "sc_w16a16" else FLOAT_ATOL)


@pytest.mark.parametrize("cid", IDS)
def test_serving_states(runs, cid):
    """Every cache leaf (per slot stacked over the group, then per remainder layer)
    after prefill and every decode step, and cache_len."""
    ref, got = runs[cid]
    atol = SC_STATE_ATOL if ref["quant"] == "sc_w16a16" else FLOAT_STATE_ATOL
    for g_state, w_state in zip([got["state0"], *got["states"]], [ref["state0"], *ref["states"]]):
        assert len(g_state[0]) == len(w_state[0])
        for g, w in zip(g_state[0], w_state[0]):
            assert g.shape == w.shape and max_diff(g, w) <= atol
        assert int(g_state[-1][0]) == int(w_state[-1][0])


@pytest.mark.parametrize("cid", [c for c in IDS if c != "w16a16"])
def test_generate_tokens_equal(runs, cid):
    ref, got = runs[cid]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))


def test_local_cache_rolls_past_the_window(runs):
    """Prompt 12, window 8: the local slot's cache holds positions 4-11, position p
    at slot p % 8, and decode step t writes slot (12 + t) % 8 only."""
    ref, got = runs["none"]
    params, cfg = got["params"], got["cfg"]
    tokens = {"tokens": torch.from_numpy(ref["tokens"])}
    with torch.no_grad():
        _, st = families.hybrid_prefill(params, dataclasses.replace(cfg, window=16), tokens, 20)
        _, st0 = families.hybrid_prefill(params, cfg, tokens, 20)
    local = cfg.layer_pattern.index("local")
    unrolled = st.group_caches[local].k[0].numpy()  # window 16: no roll, (B, 16, Hkv, Dh)
    rolled = st0.group_caches[local].k[0].numpy()
    assert rolled.shape[1] == cfg.window == 8
    for p in range(4, 12):
        np.testing.assert_array_equal(rolled[:, p % 8], unrolled[:, p])
    fns_state = st0
    from repro_torch.serve import make_serve_fns

    fns = make_serve_fns(cfg, device="cpu")
    for t, tok in enumerate(ref["fed"][:3]):
        _, _, new = fns["decode"](params, fns_state, {"token": tok})
        before, after = (s.group_caches[local].k[0].numpy() for s in (fns_state, new))
        changed = [j for j in range(8) if not np.array_equal(before[:, j], after[:, j])]
        assert changed == [(12 + t) % 8]
        fns_state = new


def test_init_decode_state_matches_the_reference():
    """Per slot LRU states (float32) and conv histories or window-sized K/V caches,
    stacked over the groups; per remainder layer its own."""
    jcfg, cfg = j_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    want = state_arrays(JF.get_family_api(jcfg)["init_decode_state"](jcfg, 3, 20))
    got = state_arrays(families.get_family_api(cfg)["init_decode_state"](cfg, 3, 20,
                                                                          device="cpu"))
    assert [a.shape for a in got[0]] == [a.shape for a in want[0]]
    assert all(not a.any() for a in got[0])


# -- the config, the geometry and the family API -------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal(smoke):
    mine, ref = get_config(NAME, smoke=smoke), j_get_config(NAME, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert families.hybrid_geometry(mine) == JF.hybrid_geometry(ref)


def test_geometry_and_module():
    """26 layers over a pattern of 3: 8 groups and 2 remainder layers, which take
    layer_pattern[0] and [1]; the smoke config's 5: one group and 2."""
    assert families.hybrid_geometry(get_config(NAME)) == (8, 3, 2)
    cfg = get_config(NAME, smoke=True)
    params = families.get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(0),
                                                  device="cpu")
    assert isinstance(params, families.HybridLM)
    assert [b.slot_type for b in params.blocks] == ["recurrent", "recurrent", "local"]
    assert [b.slot_type for b in params.rem] == ["recurrent", "recurrent"]
    assert params.rem[0].mixer.lam.dtype == torch.float32


def test_other_families_raise():
    """The name predates the encdec and vlm families' port: they now dispatch to
    their own entries, and a family no package knows still raises ValueError."""
    cfg = get_config(NAME, smoke=True)
    for fam, init in (("encdec", families.encdec_init), ("vlm", families.vlm_init)):
        assert families.get_family_api(dataclasses.replace(cfg, family=fam))["init"] is init
    with pytest.raises(ValueError, match="unknown family"):
        families.get_family_api(dataclasses.replace(cfg, family="rnn"))
