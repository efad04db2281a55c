"""Port parity, dense LM serving in float32 and under SC W8A8: the four dense
smoke configs through `make_serve_fns` against the JAX package, plus the
configs, the weight bridge, the clamped cache write, the rolling window and
the device rule.  The SC W16A16 and bf16 cases are tests/test_torch_lm_sc.py
(the two files split the JAX references' compile time).

Each case (tests/_lm.py) runs the reference once, jitted: prefill of 2
prompts of 16 tokens into caches of 24, then 3 greedy decode steps; the
port is fed the reference's greedy tokens, so every step compares on the
same inputs.

Tolerances and why (measured on this host's CPU in brackets):
  * float32 logits and float caches, atol 1e-5 [<= 3.9e-6]: the matmuls,
    the softmax and the norms sum in other orders (~1e-7 relative an op);
  * int8 caches under float: values bitwise, scales atol 1e-7 [<= 2.1e-8]
    (a K/V value within ~1e-7 of a rounding boundary of the int8 step
    would flip it; none does here);
  * generate: the greedy tokens equal the reference's (first index wins);
  * W8A8: logits atol 1e-5 [<= 1.2e-6], int8 caches bitwise: the 8-bit
    quantum (max|x| / 127) is 256x the 16-bit one, so the ~1e-7 float
    differences cross a boundary still more rarely.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from _lm import configs, jax_case, max_diff, port_case, state_arrays
from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.models import nn as j_nn
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import families
from repro_torch.models import nn as t_nn
from repro_torch.models import transformer as T
from repro_torch.params import lm_from_jax_params, lm_to_jax_params
from repro_torch.serve import make_serve_fns

jax.config.update("jax_platform_name", "cpu")

DENSE = ["stablelm-1.6b", "starcoder2-3b", "gemma3-12b", "command-r-plus-104b"]
FLOAT_ATOL = 1e-5
SCALE_ATOL = 1e-7
W8A8_ATOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]

# (id, config, quant, kv, extra jax_case arguments)
CASES = [(f"{n}-{kv}", n, "none", kv, {}) for n in DENSE for kv in ("none", "int8")] + [
    ("stablelm-w8a8-int8", "stablelm-1.6b", "sc_w8a8", "int8", {}),
    # hazard 3: caches of 16 for a prompt of 16, so every decode write clamps
    # to the last slot
    ("stablelm-clamped", "stablelm-1.6b", "none", "none", {"s_max": 16}),
    # hazard 4: gemma3's window of 8 under a prompt of 12 keeps the last 8
    # entries rolled by 12 % 8 = 4 (the prompt of 16 above rolls by 0)
    ("gemma3-rolled", "gemma3-12b", "none", "int8", {"prompt": 12, "s_max": 20}),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    """Every case through the reference and the port, once."""
    out = {}
    for cid, name, quant, kv, extra in CASES:
        ref = jax_case(name, quant, kv=kv, **extra)
        out[cid] = (ref, port_case(ref))
    return out


def _atol(cid):
    return W8A8_ATOL if "w8a8" in cid else FLOAT_ATOL


@pytest.mark.parametrize("cid", IDS)
def test_prefill_logits(runs, cid):
    ref, got = runs[cid]
    assert got["prefill"].shape == ref["prefill"].shape == (2, 1, got["cfg"].vocab_size)
    assert max_diff(got["prefill"], ref["prefill"]) <= _atol(cid)


@pytest.mark.parametrize("cid", IDS)
def test_teacher_forced_decode_logits(runs, cid):
    ref, got = runs[cid]
    assert len(got["steps"]) == len(ref["steps"]) == 3
    for step, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
        assert max_diff(g, w) <= _atol(cid), f"decode step {step}"


def _states_agree(got, want, atol):
    for slot, (gs, ws) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert g.shape == w.shape, (slot, i)
            if g.dtype == np.int32 and g.ndim:  # int8 values (compared as int32)
                np.testing.assert_array_equal(g, w, err_msg=f"slot {slot} leaf {i}")
            else:
                tol = SCALE_ATOL if (g.ndim and g.shape[-1] == 1) else atol
                assert max_diff(g, w) <= tol, (slot, i)


@pytest.mark.parametrize("cid", IDS)
def test_decode_state_caches(runs, cid):
    """After prefill and after every decode step: the caches (int8 values bitwise)
    and cache_len."""
    ref, got = runs[cid]
    _states_agree(got["state0"], ref["state0"], _atol(cid))
    for g, w in zip(got["states"], ref["states"]):
        _states_agree(g, w, _atol(cid))
    assert int(got["states"][-1][-1][0]) == int(ref["states"][-1][-1][0])


@pytest.mark.parametrize("cid", IDS)
def test_generate_tokens_equal(runs, cid):
    ref, got = runs[cid]
    np.testing.assert_array_equal(got["generate"], np.concatenate(ref["fed"], axis=1))


def test_clamped_writes_land_on_the_last_slot(runs):
    """Past the end of a cache the reference's update clamps: each decode step of
    the clamped case rewrites slot 15 and leaves slots 0-14 as prefill wrote them,
    in both packages."""
    ref, got = runs["stablelm-clamped"]
    for run in (got, ref):
        prev = run["state0"][0][0]  # slot 0's k, (n_groups, B, 16, Hkv, Dh)
        assert prev.shape[2] == 16
        for st in run["states"]:
            k = st[0][0]
            np.testing.assert_array_equal(k[:, :, :15], run["state0"][0][0][:, :, :15])
            assert not np.array_equal(k[:, :, 15], prev[:, :, 15])
            prev = k


def test_rolling_window_keeps_position_p_at_slot_p_mod_window(runs):
    """gemma3 smoke, prompt 12, window 8: after prefill a local slot holds
    positions 4-11, position p at slot p % 8, and decode step t writes slot
    (12 + t) % 8 only.  Layer 0's K does not depend on the window, so a
    window of 16 (no roll) shows where each position's K belongs."""
    ref, got = runs["gemma3-rolled"]
    cfg = got["cfg"]
    local = cfg.layer_pattern.index("local")
    assert got["state0"][local][0].shape[2] == cfg.window == 8
    assert got["state0"][cfg.layer_pattern.index("global")][0].shape[2] == 20
    wide = dataclasses.replace(cfg, window=16)
    with torch.no_grad():
        _, st = T.prefill(got["params"], wide, torch.from_numpy(ref["tokens"]), 20)
    unrolled = state_arrays(st)[local][0][0]  # layer 0's k, (B, 16, Hkv, Dh)
    rolled = got["state0"][local][0][0]
    for p in range(4, 12):
        np.testing.assert_array_equal(rolled[:, p % 8], unrolled[:, p])
    prev = got["state0"]
    for t, st in enumerate(got["states"]):
        changed = [j for j in range(8)
                   if not np.array_equal(st[local][0][:, :, j], prev[local][0][:, :, j])]
        assert changed == [(12 + t) % 8]
        prev = st


# -- configs ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_equal(name, smoke):
    mine, ref = get_config(name, smoke=smoke), j_get_config(name, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.head_dim == ref.head_dim
    assert mine.pattern_for_layers() == ref.pattern_for_layers()
    assert mine.dtype == getattr(torch, ref.dtype.name)


@pytest.mark.parametrize("name", DENSE)
def test_param_count_equal(name):
    assert get_config(name).param_count() == j_get_config(name).param_count()


# the other LM families of the port, each held by its own files
# (tests/test_torch_lm_{moe,ssm,hybrid,encdec,vlm}*.py)
PORTED = DENSE + ["granite-moe-3b-a800m", "dbrx-132b", "mamba2-1.3b", "recurrentgemma-2b",
                  "whisper-small", "internvl2-2b"]


def test_arch_ids_and_unported_configs():
    """The name predates the last families: every id of the reference now resolves,
    each to its own config, and a name no package knows raises KeyError."""
    assert ARCH_IDS == j_base.ARCH_IDS
    assert set(ARCH_IDS) == set(PORTED) | {"pointnet2-cls", "pointnet2-seg"}
    for name in ARCH_IDS:
        assert get_config(name).name == name
    with pytest.raises(KeyError):
        get_config("no-such-lm-1b")


@pytest.mark.parametrize("family,name", [("encdec", "whisper-small"), ("vlm", "internvl2-2b")])
def test_other_families_are_not_ported(family, name):
    """The name predates the encdec and vlm families' port: each family's API,
    `init` and serve fns now build on the CPU, and its prefill answers."""
    cfg = get_config(name, smoke=True)
    assert cfg.family == family
    api = families.get_family_api(cfg)
    assert set(api) == {"init", "train_loss", "prefill", "decode_step", "init_decode_state"}
    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    fns = make_serve_fns(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)}
    extra = {"encdec": ("enc_embeds", 7), "vlm": ("patch_embeds", cfg.n_patches)}[family]
    batch[extra[0]] = rng.standard_normal((2, extra[1], cfg.d_model)).astype(np.float32)
    tokens = fns["generate"](params, batch, steps=3, s_max=cfg.n_patches + 8)
    assert tokens.shape == (2, 3) and tokens.dtype == torch.int32


def test_family_api_is_the_dense_one():
    """dense and moe run on the transformer; ssm and hybrid on their own modules;
    each family's API has the reference's five entries."""
    keys = {"init", "train_loss", "prefill", "decode_step", "init_decode_state"}
    api = families.get_family_api(get_config("gemma3-12b", smoke=True))
    assert set(api) == keys
    assert api["init"] is T.init_lm and api["init_decode_state"] is T.init_decode_state
    assert api["train_loss"] is T.lm_loss
    want = {"granite-moe-3b-a800m": (T.init_lm, T.lm_loss),
            "mamba2-1.3b": (families.ssm_init, families.ssm_train_loss),
            "recurrentgemma-2b": (families.hybrid_init, families.hybrid_train_loss)}
    for name, (init, loss) in want.items():
        api = families.get_family_api(get_config(name, smoke=True))
        assert set(api) == keys and api["init"] is init and api["train_loss"] is loss


# -- the weight bridge -------------------------------------------------------------------


def _byte_identical(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_identical(name, dtype):
    jcfg, cfg = configs(name, dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(3), jcfg))
    module = lm_from_jax_params(tree, cfg, device="cpu")
    assert t_nn.count_params(module) == j_nn.count_params(tree)
    assert all(p.dtype == cfg.dtype for p in module.parameters())
    _byte_identical(lm_to_jax_params(module), tree)
    # layer i is group i // g, slot i % g
    n_groups, g = T.group_geometry(cfg)
    i = len(module.blocks) - 1
    np.testing.assert_array_equal(
        module.blocks[i].attn.wq.w.detach().float().numpy(),
        tree["blocks"][i % g]["attn"]["wq"]["w"][i // g].astype(np.float32))


def test_bridge_refuses_a_mismatched_tree():
    jcfg, cfg = configs("stablelm-1.6b")
    tree = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(0), jcfg))
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        lm_from_jax_params(bad, cfg, device="cpu")
    with pytest.raises(ValueError):
        lm_from_jax_params(tree, dataclasses.replace(cfg, dtype_str="bfloat16"), device="cpu")
    extra = dict(tree, blocks=[dict(tree["blocks"][0], extra={"w": tree["embed"][:2]})])
    with pytest.raises(ValueError):
        lm_from_jax_params(extra, cfg, device="cpu")


def test_init_is_seeded_and_shaped():
    cfg = get_config("gemma3-12b", smoke=True)
    a = T.init_lm(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    b = T.init_lm(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert a.lm_head is None and T.lm_head_weights(a, cfg).shape == (cfg.d_model, cfg.vocab_size)
    assert len(a.blocks) == 6 and [blk.slot_type for blk in a.blocks] == cfg.pattern_for_layers()
    assert abs(float(a.embed.detach().std()) - 0.02) < 2e-3


# -- the device rule -----------------------------------------------------------------------


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    cfg = get_config("stablelm-1.6b", smoke=True)
    for call in (lambda: T.init_lm(cfg), lambda: T.init_decode_state(cfg, 1, 8),
                 lambda: make_serve_fns(cfg), lambda: lm_from_jax_params({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_serve_fns_refuse_params_elsewhere():
    cfg = get_config("stablelm-1.6b", smoke=True)
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="meta")
    fns = make_serve_fns(cfg, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        fns["prefill"](params, {"tokens": np.zeros((1, 4), np.int32)}, 8)


def test_init_decode_state_matches_the_reference():
    for name in DENSE:
        for kv in ("none", "int8"):
            jcfg, cfg = configs(name, kv=kv)
            want = state_arrays(JT.init_decode_state(jcfg, 3, 20))
            got = state_arrays(T.init_decode_state(cfg, 3, 20, device="cpu"))
            for gs, ws in zip(got, want):
                for g, w in zip(gs, ws):
                    assert g.shape == w.shape and np.array_equal(g, w)


def test_torch_serve_lm_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"), "--device", "cpu",
         "--arch", "gemma3-12b", "--tokens", "4", "--quant", "sc_w16a16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prefill" in out.stdout and "sample:" in out.stdout
