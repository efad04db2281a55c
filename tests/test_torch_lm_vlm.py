"""Port parity, the vlm family (internvl2-2b): `vlm_embed` (the patch connector
and the token embeddings), then the smoke config (2 dense layers, GQA 4/2,
8 stub patches) through `make_serve_fns`, its caches under
kv_quant="int8", the config and the family API.  Training, the weight
bridge, checkpoints and the CLI are tests/test_torch_lm_encdec_vlm_train.py
and tests/test_torch_lm_encdec_vlm_launch.py.

The reference runs jitted, once per case; the port gets its params through
`params.lm_from_jax_params`.

Tolerances and why (measured on this host's CPU in brackets):
  * `vlm_embed` atol 1e-5 in float32 [<= 4.8e-7], 2e-3 under SC W16A16
    (tests/_lm.py's SC_CACHE_ATOL);
  * serving logits in float32 and W8A8 atol 1e-5 [<= 2.1e-6], caches 1e-5
    [<= 2.7e-6]; W16A16 logits within tests/_lm.py's SC bound, 5e-3
    [<= 2.6e-4], caches within SC_CACHE_ATOL, 2e-3 [<= 3.2e-4];
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
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import families
from repro_torch.models import transformer as T
from repro_torch.models.layers import KVCache
from repro_torch.params import lm_from_jax_params

jax.config.update("jax_platform_name", "cpu")

NAME = "internvl2-2b"
FLOAT_ATOL = 1e-5


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_vlm_embed_matches_reference(quant):
    """[patch_proj(patches); token embeddings]: float64 patches are cast to
    cfg.dtype first, as the reference casts them."""
    jcfg, jp = jax_params(NAME)
    _, cfg = configs(NAME)
    module = lm_from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32),
             "patch_embeds": rng.standard_normal((2, cfg.n_patches, cfg.d_model))}
    want = JF.vlm_embed(jp, jcfg, jax.tree.map(jnp.asarray, batch), policy=JPolicy(quant=quant))
    with torch.no_grad():
        got = families.vlm_embed(module, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 policy=ExecutionPolicy(quant=quant))
    assert got.dtype == torch.float32 and got.shape == (2, cfg.n_patches + 5, cfg.d_model)
    assert max_diff(got, np.asarray(want)) <= (FLOAT_ATOL if quant == "none" else SC_CACHE_ATOL)


# -- serving through make_serve_fns --------------------------------------------------

CASES = [("none", "none", {}), ("w16a16", "sc_w16a16", {}), ("w8a8", "sc_w8a8", {}),
         ("kv-int8", "none", {"kv": "int8"})]
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
    """Every slot's K/V caches (n_groups, B, S_max, Hkv, Dh), S_max counting the
    8 patches, after prefill and every decode step; cache_len = 8 + 16 + step."""
    ref, got = runs[cid]
    if ref["quant"] == "sc_w16a16":
        assert_sc_states_close(ref, got)
        return
    for g_state, w_state in zip([got["state0"], *got["states"]], [ref["state0"], *ref["states"]]):
        for gs, ws in zip(g_state[:-1], w_state[:-1]):
            for g, w in zip(gs, ws):
                assert g.shape == w.shape and max_diff(g, w) <= FLOAT_ATOL
        assert int(g_state[-1][0]) == int(w_state[-1][0])
    assert int(got["state0"][-1][0]) == got["cfg"].n_patches + 16


@pytest.mark.parametrize("cid", [c for c in IDS if c != "w16a16"])
def test_generate_tokens_equal(runs, cid):
    ref, got = runs[cid]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))


def test_int8_kv_quant_leaves_the_prefill_caches_float(runs):
    """Under kv_quant="int8" the reference's vlm prefill keeps float caches (it does
    not go through the dense prefill, which would quantize them), so decode takes
    the float path: the port's caches are float KVCaches too, and the run equals
    the float one.  A fresh init_decode_state still follows the config (int8)."""
    ref, got = runs["kv-int8"]
    base_ref, base_got = runs["none"]
    for state in (ref["state0"], *ref["states"]):
        assert all(a.dtype == np.float32 for slot in state[:-1] for a in slot)
    cfg = got["cfg"]
    batch = {"tokens": torch.from_numpy(ref["tokens"]),
             "patch_embeds": torch.from_numpy(ref["inputs"]["patch_embeds"])}
    with torch.no_grad():
        _, st = families.vlm_prefill(got["params"], cfg, batch, ref["s_max"])
    assert all(type(c) is KVCache and c.k.dtype == torch.float32 for c in st.caches)
    np.testing.assert_array_equal(got["prefill"], base_got["prefill"])
    for g, w in zip(got["steps"], base_got["steps"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ref["prefill"], base_ref["prefill"])
    fresh = families.get_family_api(cfg)["init_decode_state"](cfg, 2, 12, device="cpu")
    assert fresh.caches[0].k.dtype == torch.int8


def test_init_decode_state_matches_the_reference():
    jcfg, cfg = j_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    want = state_arrays(JF.get_family_api(jcfg)["init_decode_state"](jcfg, 3, 20))
    got = state_arrays(families.get_family_api(cfg)["init_decode_state"](cfg, 3, 20,
                                                                          device="cpu"))
    assert [[a.shape for a in s] for s in got] == [[a.shape for a in s] for s in want]


# -- the config and the family API ---------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal(smoke):
    """The count leaves patch_proj out, as the reference's does."""
    mine, ref = get_config(NAME, smoke=smoke), j_get_config(NAME, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    if not smoke:
        assert mine.param_count() == 1_889_046_528


def test_family_api_and_module():
    """The dense stack behind a connector: GLU blocks, an untied head, patch_proj
    (D, D) with a bias in cfg.dtype; decode and init_decode_state are the
    transformer's."""
    cfg = dataclasses.replace(get_config(NAME, smoke=True), dtype_str="bfloat16")
    api = families.get_family_api(cfg)
    assert set(api) == {"init", "train_loss", "prefill", "decode_step", "init_decode_state"}
    assert api["init_decode_state"] is T.init_decode_state
    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(params, families.VLM) and isinstance(params, T.DenseLM)
    assert params.patch_proj.w.shape == (cfg.d_model, cfg.d_model)
    assert params.patch_proj.w.dtype == params.patch_proj.b.dtype == torch.bfloat16
    assert params.lm_head is not None and len(params.blocks) == cfg.n_layers
    T.check_transformer(cfg)
