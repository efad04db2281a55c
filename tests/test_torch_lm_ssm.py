"""Port parity, the ssm family (mamba2-1.3b): `models/mamba2.py` against the
reference's `_segsum`, `ssd_forward` and `mamba2_apply` (train and decode),
then the smoke config through `make_serve_fns`, the config and the family
API.  Training, the weight bridge, checkpoints and the CLI are
tests/test_torch_lm_ssm_train.py (the two files split the JAX references'
compile time).

The reference runs jitted, once per case; the port gets its params through
`params.lm_from_jax_params`.

Tolerances and why (measured on this host's CPU in brackets):
  * `segsum`, atol 1e-6 of sums up to ~8 [<= 4.8e-7]: the same two
    cumulative sums and one subtraction, but torch's CPU cumsum lands an ulp
    from XLA's (and numpy's) sequential one; -inf above the diagonal equal;
  * `ssd_forward` in float32, atol 1e-4 of outputs up to ~30 [<= 4.8e-6],
    against the reference and against a sequential float64 loop: the
    contractions sum in other orders (the reference's 4-operand einsums
    contract in XLA's order), and a state carries over a chunk's 8-16
    steps; another chunk size gives the same answer within the same bound;
  * `mamba2_apply` (out, state, conv history) and serving (logits, states)
    in float32 and W8A8, atol 1e-5 [<= 1.5e-6]; under W16A16 the block
    [<= 2.4e-7] and the states [<= 2.7e-5] within SC_STATE_ATOL, 2e-3 (one
    quantum of a flipped rounding), the logits within tests/_lm.py's SC
    bound, 5e-3 [<= 1.1e-5];
  * generate's tokens equal in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import SC_LOGIT_ATOL, assert_logits_close, jax_case, max_diff, port_case
from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import families as JF
from repro.models import mamba2 as JM
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import families
from repro_torch.models import mamba2 as M

jax.config.update("jax_platform_name", "cpu")

NAME = "mamba2-1.3b"
SEGSUM_ATOL = 1e-6
SSD_ATOL = 1e-4
FLOAT_ATOL = 1e-5
SC_STATE_ATOL = 2e-3



def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- segsum and the chunked SSD --------------------------------------------------------


def test_segsum_is_the_references():
    dta = -np.abs(np.random.default_rng(0).standard_normal((2, 3, 8))).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(dta)))
    got = M.segsum(_t(dta)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert max_diff(got[finite], want[finite]) <= SEGSUM_ATOL


def _ssd_inputs(s: int, seed: int, b=2, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _ssd_loop(x, dt, A, B, C):
    """The sequential recurrence in float64: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = C_t h_t."""
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    b, s, h, p = x.shape
    state = np.zeros((b, h, p, B.shape[-1]))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        state = state * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", C[:, t], state)
    return ys, state


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 16), (12, 64)])
def test_ssd_forward_matches_reference_and_the_loop(s, chunk):
    """24 over chunks of 16 halves the chunk to 8; 12 over 64 is one chunk of 12."""
    args = _ssd_inputs(s, seed=s)
    y_ref, st_ref = JM.ssd_forward(*map(jnp.asarray, args), chunk=chunk)
    y, st = M.ssd_forward(*map(_t, args), chunk=chunk)
    assert y.shape == (2, s, 3, 4) and st.shape == (2, 3, 4, 8)
    assert max_diff(y, np.asarray(y_ref)) <= SSD_ATOL
    assert max_diff(st, np.asarray(st_ref)) <= SSD_ATOL
    y_loop, st_loop = _ssd_loop(*args)
    assert max_diff(y, y_loop) <= SSD_ATOL and max_diff(st, st_loop) <= SSD_ATOL


def test_ssd_forward_does_not_depend_on_the_chunk():
    args = tuple(map(_t, _ssd_inputs(32, seed=7)))
    y8, st8 = M.ssd_forward(*args, chunk=8)
    for chunk in (4, 16, 32):
        y, st = M.ssd_forward(*args, chunk=chunk)
        assert max_diff(y, y8) <= SSD_ATOL and max_diff(st, st8) <= SSD_ATOL


# -- mamba2_apply ---------------------------------------------------------------------


def _block_pair(seed: int = 0):
    """(reference config, its mamba2 params, port config, a Mamba2 holding them)."""
    jcfg, cfg = j_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    jp = JM.mamba2_init(jax.random.PRNGKey(seed), jcfg)
    module = M.Mamba2(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = jp
            for part in name.split("."):
                node = node[part]
            p.copy_(_t(node))
    return jcfg, jp, cfg, module


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_mamba2_apply_train_and_decode_match_reference(quant):
    """A prefill of 12 tokens, then two decode steps from its cache."""
    jcfg, jp, cfg, module = _block_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    steps = [rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) for _ in range(2)]
    jpol, pol = JPolicy(quant=quant), ExecutionPolicy(quant=quant)
    atol = FLOAT_ATOL if quant == "none" else SC_STATE_ATOL
    fwd = jax.jit(lambda p, v: JM.mamba2_apply(p, jcfg, v, policy=jpol))
    dec = jax.jit(lambda p, v, c: JM.mamba2_apply(p, jcfg, v, cache=c, policy=jpol))
    out_w, cache_w, state_w = fwd(jp, jnp.asarray(x))
    with torch.no_grad():
        out, cache, state = M.mamba2_apply(module, cfg, _t(x), policy=pol)
        assert max_diff(out, np.asarray(out_w)) <= atol
        assert max_diff(cache.state, np.asarray(cache_w.state)) <= atol
        assert max_diff(cache.conv, np.asarray(cache_w.conv)) <= atol
        assert cache.conv.shape == (2, cfg.ssm_conv - 1, M.mamba2_dims(cfg)[2])
        for v in steps:
            out_w, cache_w, _ = dec(jp, jnp.asarray(v), cache_w)
            out, cache, _ = M.mamba2_apply(module, cfg, _t(v), cache=cache, policy=pol)
            assert max_diff(out, np.asarray(out_w)) <= atol
            assert max_diff(cache.state, np.asarray(cache_w.state)) <= atol
            assert max_diff(cache.conv, np.asarray(cache_w.conv)) <= atol


def test_a_prompt_shorter_than_the_conv_keeps_a_left_padded_tail():
    """Two tokens under a conv of width 4: the tail is one zero row, then the two
    raw inputs, as the reference pads it; decode from it agrees too."""
    jcfg, jp, cfg, module = _block_pair(seed=2)
    x = np.random.default_rng(3).standard_normal((2, 2, cfg.d_model)).astype(np.float32)
    out_w, cache_w, _ = JM.mamba2_apply(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        out, cache, _ = M.mamba2_apply(module, cfg, _t(x))
    assert max_diff(out, np.asarray(out_w)) <= FLOAT_ATOL
    assert bool((cache.conv[:, 0] == 0).all()) and cache.conv.shape[1] == 3
    assert max_diff(cache.conv, np.asarray(cache_w.conv)) <= FLOAT_ATOL


# -- serving through make_serve_fns --------------------------------------------------

# (id, quant, extra jax_case arguments): a prompt of 2 is shorter than the
# conv's history of 3
CASES = [("none", "none", {}), ("w16a16", "sc_w16a16", {}), ("w8a8", "sc_w8a8", {}),
         ("short-prompt", "none", {"prompt": 2, "s_max": 8})]
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
    """The stacked SSM states and conv histories after prefill and every decode
    step, and cache_len."""
    ref, got = runs[cid]
    atol = SC_STATE_ATOL if ref["quant"] == "sc_w16a16" else FLOAT_ATOL
    for g_state, w_state in zip([got["state0"], *got["states"]], [ref["state0"], *ref["states"]]):
        (g_ssm, g_conv), (w_ssm, w_conv) = g_state[0], w_state[0]
        assert g_ssm.shape == w_ssm.shape and g_conv.shape == w_conv.shape
        assert max_diff(g_ssm, w_ssm) <= atol and max_diff(g_conv, w_conv) <= atol
        assert int(g_state[-1][0]) == int(w_state[-1][0])


@pytest.mark.parametrize("cid", [c for c in IDS if c != "w16a16"])
def test_generate_tokens_equal(runs, cid):
    ref, got = runs[cid]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))


def test_init_decode_state_matches_the_reference():
    """Zero stacked states (float32) and conv histories (the config's dtype)."""
    jcfg, cfg = j_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    want = JF.get_family_api(jcfg)["init_decode_state"](jcfg, 3, 20)
    got = families.get_family_api(cfg)["init_decode_state"](cfg, 3, 20, device="cpu")
    for g, w in zip((*got.caches, got.cache_len), (*want.caches, want.cache_len)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == w.dtype.name
        assert not bool(g.any())


# -- the config and the family API ---------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal(smoke):
    mine, ref = get_config(NAME, smoke=smoke), j_get_config(NAME, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert M.mamba2_dims(mine) == JM.mamba2_dims(ref)


def test_family_api_and_module():
    cfg = get_config(NAME, smoke=True)
    api = families.get_family_api(cfg)
    assert set(api) == {"init", "train_loss", "prefill", "decode_step", "init_decode_state"}
    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(params, families.SSMLM) and len(params.blocks) == cfg.n_layers
    mixer = params.blocks[0].mixer
    assert {mixer.A_log.dtype, mixer.D.dtype, mixer.dt_bias.dtype} == {torch.float32}
    bf16 = dataclasses.replace(cfg, dtype_str="bfloat16")
    bf16_params = api["init"](bf16, generator=torch.Generator().manual_seed(0), device="cpu")
    mixer = bf16_params.blocks[0].mixer
    assert mixer.in_proj.w.dtype == torch.bfloat16 and mixer.A_log.dtype == torch.float32
