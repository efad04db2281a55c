"""Port parity, the encdec family (whisper-small): the sinusoidal table, the
cross-attention branch of the attention block, the encoder (`encode`, the
reference's `_encode`) and one decoder layer (`DecBlock`, the reference's
`_dec_slot_apply`) in train, prefill and decode, then the smoke config (2
encoder and 2 decoder layers, 24 stub encoder frames) through
`make_serve_fns`, the config and the family API.  Training, the weight
bridge, checkpoints and the CLI are tests/test_torch_lm_encdec_vlm_train.py
and tests/test_torch_lm_encdec_vlm_launch.py.

The reference runs jitted where it serves, once per case; the port gets
its params through `params.lm_from_jax_params`.

Tolerances and why (measured on this host's CPU in brackets):
  * the sinusoidal table is not bitwise: XLA's CPU exp lands an ulp from
    torch's on some inverse frequencies (43 of 384 at d = 768), and sin and
    cos on ~2 % of the entries, so the tables part by up to the largest
    angle's ulp: SINUSOIDAL_ATOL per (positions, width) [1.2e-7 at 64 x 64,
    3.1e-5 at 448 x 768, 1.2e-4 at 1536 x 768, the ulp of 1535];
  * cross-attention, the encoder and a decoder layer atol 1e-5 in float32
    [<= 1.5e-6], 2e-3 under SC W16A16 (tests/_lm.py's SC_CACHE_ATOL: one
    activation quantum moves a value by ~1e-4);
  * serving logits in float32 and W8A8 atol 1e-5 [<= 2.1e-7], their caches
    1e-5 [<= 1.5e-6]; W16A16 logits within tests/_lm.py's SC bound, 5e-3
    [<= 3.6e-5], caches within SC_CACHE_ATOL, 2e-3 [<= 2.7e-4];
  * generate's tokens equal in float32 and W8A8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import (SC_CACHE_ATOL, SC_LOGIT_ATOL, assert_logits_close, assert_sc_states_close,
                 configs, jax_case, jax_params, max_diff, port_case, state_arrays)
from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import families as JF
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import families
from repro_torch.models import transformer as T
from repro_torch.params import lm_from_jax_params

jax.config.update("jax_platform_name", "cpu")

NAME = "whisper-small"
FLOAT_ATOL = 1e-5
# (positions, width): the table's bound, about the ulp of the largest angle
SINUSOIDAL_ATOL = {(24, 64): 1.2e-7, (64, 64): 2.4e-7, (448, 768): 6.1e-5,
                   (1536, 768): 2.44e-4}
QUANTS = ["none", "sc_w16a16"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _atol(quant: str) -> float:
    return FLOAT_ATOL if quant == "none" else SC_CACHE_ATOL


@pytest.fixture(scope="module")
def model():
    """(reference config, its smoke params, port config, the port's module holding
    them, seeded inputs)."""
    jcfg, jp = jax_params(NAME)
    _, cfg = configs(NAME)
    module = lm_from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(5)
    x = {"enc": rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32),
         "h": rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32),
         "h1": rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)}
    return jcfg, jp, cfg, module, x


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# -- the sinusoidal table ---------------------------------------------------------------


@pytest.mark.parametrize("s,d", list(SINUSOIDAL_ATOL))
def test_sinusoidal_table_within_the_angles_ulp(s, d):
    got = families.sinusoidal_pos(s, d)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    assert max_diff(got, np.asarray(JF._sinusoidal_pos(s, d))) <= SINUSOIDAL_ATOL[s, d]


# -- cross-attention, the encoder, a decoder layer -----------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("s", [6, 1])
def test_cross_attention_matches_reference(model, quant, s):
    """Decoder layer 0's cross_attn over 24 encoder rows: a query of 6 (non-causal
    flash attention over block pairs of 2) and of 1 (decode attention over all 24)."""
    jcfg, jp, cfg, module, x = model
    xq, src = (x["h"] if s == 6 else x["h1"]), x["enc"]
    want, _ = JL.attn_apply(
        _layer0(jp["dec_blocks"])["cross_attn"], JT.attn_cfg_for(jcfg, "global", causal=False),
        jnp.asarray(xq), positions=jnp.arange(s)[None], kv_override=(jnp.asarray(src),) * 2,
        attn_block=jcfg.attn_block, policy=JPolicy(quant=quant))
    with torch.no_grad():
        got, _ = module.dec_blocks[0].cross_attn(
            _t(xq), positions=torch.arange(s)[None], kv_override=(_t(src),) * 2,
            attn_block=cfg.attn_block, policy=ExecutionPolicy(quant=quant))
    assert got.shape == (2, s, cfg.d_model)
    assert max_diff(got, np.asarray(want)) <= _atol(quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_encoder_matches_reference(model, quant):
    jcfg, jp, cfg, module, x = model
    want = JF._encode(jp, jcfg, jnp.asarray(x["enc"]), policy=JPolicy(quant=quant))
    with torch.no_grad():
        got = families.encode(module, cfg, _t(x["enc"]), policy=ExecutionPolicy(quant=quant))
    assert got.shape == x["enc"].shape
    assert max_diff(got, np.asarray(want)) <= _atol(quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_decoder_layer_train_prefill_and_decode_match_reference(model, quant):
    """`_dec_slot_apply` of decoder layer 0: train (no caches), prefill (the self
    and cross K/V collected, the cross K/V projected once) and one decode step
    at position 6 against the prefill's caches (the self cache padded to 10)."""
    jcfg, jp, cfg, module, x = model
    jpol, pol = JPolicy(quant=quant), ExecutionPolicy(quant=quant)
    p0, block, atol = _layer0(jp["dec_blocks"]), module.dec_blocks[0], _atol(quant)
    enc, h, h1 = (jnp.asarray(x[k]) for k in ("enc", "h", "h1"))
    pos = jnp.arange(6)[None]
    w_train, _, _ = JF._dec_slot_apply(jcfg, p0, h, enc, positions=pos, policy=jpol)
    w_pre, w_self, w_cross = JF._dec_slot_apply(jcfg, p0, h, enc, positions=pos, collect=True,
                                                policy=jpol)
    pad = [(0, 0), (0, 4), (0, 0), (0, 0)]
    w_cache = JL.KVCache(jnp.pad(w_self.k, pad), jnp.pad(w_self.v, pad))
    w_dec, w_new, _ = JF._dec_slot_apply(
        jcfg, p0, h1, None, positions=jnp.full((1, 1), 6), self_cache=w_cache,
        cache_len=jnp.asarray(6, jnp.int32), cross_kv=w_cross, policy=jpol)
    kw = dict(attn_block=cfg.attn_block, policy=pol)
    with torch.no_grad():
        g_train, none_self, none_cross = block(_t(x["h"]), _t(x["enc"]),
                                               positions=torch.arange(6)[None], **kw)
        g_pre, g_self, g_cross = block(_t(x["h"]), _t(x["enc"]), positions=torch.arange(6)[None],
                                       collect=True, **kw)
        cache = families.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4)) for t in g_self))
        cl = torch.tensor(6, dtype=torch.int32)
        g_dec, g_new, g_cross_out = block(_t(x["h1"]), positions=cl.reshape(1, 1),
                                          self_cache=cache, cache_len=cl, cross=g_cross, **kw)
    assert none_self is None and none_cross is None and g_cross_out is g_cross
    assert g_cross.k.shape == (2, 24, cfg.n_kv_heads, cfg.head_dim)
    for got, want in [(g_train, w_train), (g_pre, w_pre), (g_self.k, w_self.k),
                      (g_self.v, w_self.v), (g_cross.k, w_cross.k), (g_cross.v, w_cross.v),
                      (g_dec, w_dec), (g_new.k, w_new.k), (g_new.v, w_new.v)]:
        assert got.shape == want.shape and max_diff(got, np.asarray(want)) <= atol


# -- serving through make_serve_fns --------------------------------------------------

# (id, quant, extra jax_case arguments): a one-token prompt takes the
# cross-attention's decode branch in prefill; int8 KV caches stay float
CASES = [("none", "none", {}), ("w16a16", "sc_w16a16", {}), ("w8a8", "sc_w8a8", {}),
         ("one-token", "none", {"prompt": 1}), ("kv-int8", "none", {"kv": "int8"})]
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
    """Self caches (L, B, S_max, Hkv, Dh), cross caches (L, B, S_enc, Hkv, Dh) and
    cache_len after prefill and every decode step."""
    ref, got = runs[cid]
    if ref["quant"] == "sc_w16a16":
        assert_sc_states_close(ref, got)
        return
    for g_state, w_state in zip([got["state0"], *got["states"]], [ref["state0"], *ref["states"]]):
        assert [a.shape for a in g_state[0]] == [a.shape for a in w_state[0]]
        for g, w in zip(g_state[0], w_state[0]):
            assert max_diff(g, w) <= FLOAT_ATOL
        assert int(g_state[-1][0]) == int(w_state[-1][0])


@pytest.mark.parametrize("cid", [c for c in IDS if c != "w16a16"])
def test_generate_tokens_equal(runs, cid):
    ref, got = runs[cid]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))


def test_int8_kv_quant_leaves_the_caches_float(runs):
    """kv_quant="int8" changes nothing here, in the reference or in the port: the
    caches are float KVCaches of cfg.dtype and the run equals the float one."""
    ref, got = runs["kv-int8"]
    base_ref, base_got = runs["none"]
    for state in (ref["state0"], *ref["states"]):
        assert all(a.dtype == np.float32 for a in state[0])  # int8 would come back int32
    cfg = got["cfg"]
    batch = {"tokens": _t(ref["tokens"]), "enc_embeds": _t(ref["inputs"]["enc_embeds"])}
    with torch.no_grad():
        _, st = families.encdec_prefill(got["params"], cfg, batch, ref["s_max"])
    assert isinstance(st.self_caches, families.KVCache)
    assert {t.dtype for t in (*st.self_caches, *st.cross_caches)} == {torch.float32}
    np.testing.assert_array_equal(got["prefill"], base_got["prefill"])
    np.testing.assert_array_equal(ref["prefill"], base_ref["prefill"])


def test_caches_hold_s_max_and_the_encoder_frames(runs):
    """s_max pads only the self caches; the cross caches keep the 24 frames."""
    ref, got = runs["none"]
    self_k, _, cross_k, _ = got["state0"][0]
    assert self_k.shape[2] == ref["s_max"] and cross_k.shape[2] == 24
    assert not self_k[:, :, 16:].any() and int(got["state0"][-1][0]) == 16


def test_init_decode_state_matches_the_reference():
    jcfg, cfg = j_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    for s_enc in (None, 12):
        want = state_arrays(JF.encdec_init_decode_state(jcfg, 3, 20, s_enc=s_enc))
        st = families.get_family_api(cfg)["init_decode_state"](cfg, 3, 20, s_enc, device="cpu")
        got = state_arrays(st)
        assert [a.shape for a in got[0]] == [a.shape for a in want[0]]
        assert all(not a.any() for a in got[0]) and st.self_caches.k.dtype == cfg.dtype
        assert st.cache_len.dtype == torch.int32 and int(st.cache_len) == 0


# -- the config and the family API ---------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal(smoke):
    mine, ref = get_config(NAME, smoke=smoke), j_get_config(NAME, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    if not smoke:
        assert mine.param_count() == 238_013_184


def test_family_api_and_module():
    cfg = get_config(NAME, smoke=True)
    api = families.get_family_api(cfg)
    assert set(api) == {"init", "train_loss", "prefill", "decode_step", "init_decode_state"}
    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(params, families.EncDecLM)
    assert (len(params.enc_blocks), len(params.dec_blocks)) == (2, 2)
    assert params.enc_blocks[0].attn.cfg.causal is False
    assert params.dec_blocks[0].self_attn.cfg.causal is True
    assert params.dec_blocks[0].cross_attn.cfg.causal is False
    assert isinstance(params.enc_norm, type(T.norm(cfg, "cpu", cfg.dtype)))
    with pytest.raises(ValueError, match="get_family_api"):
        T.init_lm(cfg, device="cpu")
