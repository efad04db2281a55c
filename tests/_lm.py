"""Shared harness of the LM parity tests: one serving case run through the JAX
package and through the port on the same params and tokens, and the
training, bridge and checkpoint checks every LM family shares.

A case is a smoke config of any family (dense, moe, ssm, hybrid, encdec,
vlm) with a quant policy, a KV-cache kind and a dtype; encdec and vlm
prefills also take seeded stub frontend outputs (`frontend_inputs`), fed
to both packages.  The JAX side
initialises the reference's params through its family API, prefills a
seeded prompt and takes `steps` greedy decode steps, both jitted once; the
port gets the same params through `lm_from_jax_params` and is fed the
reference's greedy tokens (teacher forcing), so each step's logits compare
on the same inputs.  Its own `generate` runs too: in float32 its tokens
must be the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import families as JF
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.params import lm_from_jax_params
from repro_torch.serve import make_serve_fns

BATCH, PROMPT, S_MAX, STEPS = 2, 16, 24, 3
S_ENC = 24  # encdec: encoder frames of a case's stub frontend output


def configs(name: str, *, kv: str = "none", dtype: str | None = None):
    """The (JAX, port) smoke configs of `name` with the KV cache kind and dtype applied."""
    change = {"kv_quant": kv}
    if dtype:
        change["dtype_str"] = dtype
    return (dataclasses.replace(j_get_config(name, smoke=True), **change),
            dataclasses.replace(get_config(name, smoke=True), **change))


def _f32(a) -> np.ndarray:
    """A numpy copy for comparison: int8 as int32, floats (bf16 too) as float32."""
    a = np.asarray(a)
    return a.astype(np.int32) if a.dtype == np.int8 else a.astype(np.float32)


def _host(t):
    if not torch.is_tensor(t):
        return t
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _leaves(tree) -> list:
    """The array leaves of a decode state (either package's), fields in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [] if tree is None else [tree]


def state_arrays(state) -> list[list[np.ndarray]]:
    """A decode state (either package's) as numpy, then cache_len last: a dense or
    moe DecodeState slot by slot; an ssm or hybrid state as one list of its
    cache leaves in field order (stacked state and conv, or per slot then per
    remainder layer)."""
    n = state.cache_len
    if isinstance(getattr(state, "caches", None), tuple) and not hasattr(state.caches, "_fields"):
        out = [[_f32(_host(t)) for t in cache] for cache in state.caches]
    else:
        out = [[_f32(_host(t)) for t in _leaves(tuple(state)[:-1])]]
    out.append([np.asarray(n.cpu().numpy() if torch.is_tensor(n) else n)])
    return out


def frontend_inputs(cfg, b: int, seed: int, s_enc: int = S_ENC) -> dict:
    """Seeded float32 stub frontend outputs of cfg's family: enc_embeds (b, s_enc,
    D) for encdec, patch_embeds (b, n_patches, D) for vlm, none for the others."""
    rng = np.random.default_rng(1000 + seed)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal((b, cfg.n_patches, cfg.d_model))
                .astype(np.float32)}
    return {}


def jax_case(name: str, quant: str, *, kv: str = "none", dtype: str | None = None,
             prompt: int = PROMPT, s_max: int = S_MAX, steps: int = STEPS, seed: int = 1,
             s_enc: int = S_ENC) -> dict:
    """The reference's run of one case (params, tokens, logits, states, greedy tokens).

    s_max counts the prompt and the generated tokens; a vlm's caches hold its
    patches as well, so its s_max grows by n_patches."""
    jcfg, _ = configs(name, kv=kv, dtype=dtype)
    api = JF.get_family_api(jcfg)
    jp = api["init"](jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    inputs = frontend_inputs(jcfg, BATCH, seed, s_enc)
    if jcfg.family == "vlm":
        s_max += jcfg.n_patches
    pol = JPolicy(quant=quant)
    pre = jax.jit(lambda p, b: api["prefill"](p, jcfg, b, s_max, policy=pol))
    dec = jax.jit(lambda p, st, t: api["decode_step"](p, jcfg, st, {"token": t}, policy=pol))
    logits, st = pre(jp, {"tokens": jnp.asarray(tokens),
                          **{k: jnp.asarray(v) for k, v in inputs.items()}})
    out = {"name": name, "quant": quant, "kv": kv, "dtype": dtype, "inputs": inputs,
           "s_max": s_max, "tree": jax.tree.map(np.asarray, jp), "tokens": tokens,
           "prefill": _f32(logits), "state0": state_arrays(st), "steps": [], "states": []}
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    fed = [np.asarray(tok)]
    for _ in range(steps):
        logits, st = dec(jp, st, tok)
        out["steps"].append(_f32(logits))
        out["states"].append(state_arrays(st))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        fed.append(np.asarray(tok))
    out["fed"] = fed
    return out


def port_case(ref: dict) -> dict:
    """The port's run of `ref`'s case on the CPU: the same params, prompt and fed tokens."""
    _, cfg = configs(ref["name"], kv=ref["kv"], dtype=ref["dtype"])
    params = lm_from_jax_params(ref["tree"], cfg, device="cpu")
    fns = make_serve_fns(cfg, ExecutionPolicy(quant=ref["quant"]), device="cpu")
    out = {"params": params, "cfg": cfg, "steps": [], "states": []}
    batch = {"tokens": ref["tokens"], **ref["inputs"]}
    with torch.no_grad():
        logits, st = fns["prefill"](params, batch, ref["s_max"])
        out["prefill"], out["state0"] = _f32(logits.numpy()), state_arrays(st)
        for tok in ref["fed"][:len(ref["steps"])]:
            logits, _, st = fns["decode"](params, st, {"token": tok})
            out["steps"].append(_f32(logits.numpy()))
            out["states"].append(state_arrays(st))
        out["generate"] = fns["generate"](params, batch,
                                          steps=len(ref["steps"]) + 1,
                                          s_max=ref["s_max"]).numpy()
    return out


def max_diff(a, b) -> float:
    """max |a - b| as a float."""
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# SC W16A16 tolerances (tests/test_torch_lm_sc.py says why)
SC_LOGIT_ATOL = 5e-3
SC_CACHE_ATOL = 2e-3
SC_SCALE_ATOL = 1e-4


def assert_logits_close(ref: dict, got: dict, atol: float) -> None:
    """Prefill logits and every teacher-forced decode step's within atol."""
    assert got["prefill"].shape == ref["prefill"].shape
    assert np.isfinite(got["prefill"]).all()
    assert max_diff(got["prefill"], ref["prefill"]) <= atol, "prefill"
    assert len(got["steps"]) == len(ref["steps"])
    for step, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
        assert max_diff(g, w) <= atol, f"decode step {step}"


def assert_sc_states_close(ref: dict, got: dict) -> None:
    """Under SC: float caches within SC_CACHE_ATOL, int8 values within one step,
    their scales within SC_SCALE_ATOL, cache_len equal; after prefill and each step."""
    for g_state, w_state in zip([got["state0"], *got["states"]],
                                [ref["state0"], *ref["states"]]):
        for gs, ws in zip(g_state[:-1], w_state[:-1]):
            for g, w in zip(gs, ws):
                assert g.shape == w.shape
                if g.dtype == np.int32:  # int8 values
                    assert max_diff(g, w) <= 1
                elif g.shape[-1] == 1:  # their scales
                    assert max_diff(g, w) <= SC_SCALE_ATOL
                else:
                    assert max_diff(g, w) <= SC_CACHE_ATOL
        assert int(g_state[-1][0]) == int(w_state[-1][0])


# -- training, the bridge and checkpoints, for any family ---------------------------
#
# Bounds of tests/test_torch_lm_train.py, which says why: float32 loss 1e-5
# and every gradient leaf within 1e-5 of its max |g|; SC W16A16 loss 1e-3,
# the nonzero pattern above 1e-30 equal and each value within 1e-3 of the
# leaf's max (2e-2 where that max is below 1e-3: the scale path); a train
# step's loss within 1e-4 (float) / 1e-3 (SC) of the reference's jitted step.

LOSS_ATOL = {"none": 1e-5, "sc_w16a16": 1e-3}
FLOAT_GRAD_REL = 1e-5
SC_FLOOR = 1e-30
SC_GRAD_REL, SC_VALUE_SCALE, SC_SCALE_PATH_REL = 1e-3, 1e-3, 2e-2
STEP_LOSS_ATOL = {"none": 1e-4, "sc_w16a16": 1e-3}


def token_batch(vocab: int, b: int, s: int, seed: int) -> dict:
    """Seeded numpy tokens and their next-token labels."""
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def family_batch(cfg, b: int, s: int, seed: int) -> dict:
    """`token_batch` and, for encdec and vlm, seeded stub frontend outputs (encdec's
    of s frames, as the reference's train_lm stubs them)."""
    return {**token_batch(cfg.vocab_size, b, s, seed), **frontend_inputs(cfg, b, seed, s)}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def jax_params(name: str, dtype: str | None = None, seed: int = 0):
    """(config, params) of the reference's smoke config through its family API."""
    jcfg, _ = configs(name, dtype=dtype)
    init = JF.get_family_api(jcfg)["init"]
    return jcfg, jax.jit(lambda key: init(key, jcfg))(jax.random.PRNGKey(seed))


def jax_grads(name: str, quant: str, batch: dict) -> dict:
    """The reference's params, its jitted train_loss and gradient leaves on `batch`."""
    jcfg, jp = jax_params(name)
    api = JF.get_family_api(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: api["train_loss"](p, jcfg, b, policy=JPolicy(quant=quant))[0]))
    loss, grads = fn(jp, jax.tree.map(jnp.asarray, batch))
    return dict(tree=jax.tree.map(np.asarray, jp), batch=batch, loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def port_grads(name: str, quant: str, ref: dict) -> tuple[float, list]:
    """The port's train_loss and gradient leaves (the reference's order) for `ref`."""
    from repro_torch.models.families import get_family_api
    from repro_torch.params import _lm_tree, lm_layout, named_jax_params, tree_leaves

    _, cfg = configs(name)
    params = lm_from_jax_params(ref["tree"], cfg, device="cpu")
    named = named_jax_params(params)
    loss, _ = get_family_api(cfg)["train_loss"](params, cfg, torch_batch(ref["batch"]),
                                                 policy=ExecutionPolicy(quant=quant))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return float(loss), [g.numpy() for g in tree_leaves(_lm_tree(grads, *lm_layout(cfg)))]


# An attention key bias shifts every score of a query row by the same q . b,
# which the softmax cancels: its gradient is zero in exact arithmetic, and
# each package's is rounding noise (whisper smoke: |g| <= 1.1e-9 of a tree
# whose largest gradient is 5.7e-2).  Such leaves are held to ZERO_GRAD_REL
# of the tree's largest |g| on both sides, not to their own max.
ZERO_GRAD_REL = 1e-6


def zero_grad_leaves(tree) -> set:
    """Indices, in `jax.tree.leaves` order, of the leaves whose exact gradient is
    zero: the key biases of every attention (encdec's wk.b)."""
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return {i for i, p in enumerate(paths) if p[-2:] == ("wk", "b")}


def assert_grads_close(got: list, want: list, quant: str,
                       float_rel: float = FLOAT_GRAD_REL, zero: set = frozenset()) -> None:
    """Every leaf, in the reference's order, by the bounds above (`float_rel` of the
    leaf's max in float); the leaves of `zero` (`zero_grad_leaves`) by
    ZERO_GRAD_REL of the largest gradient."""
    assert len(got) == len(want)
    largest = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"leaf {i}"
        if i in zero:
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= ZERO_GRAD_REL * largest
            continue
        top = float(np.abs(w).max())
        if quant == "none":
            assert np.abs(g - w).max() <= float_rel * top, f"leaf {i}"
        else:
            np.testing.assert_array_equal(np.abs(g) > SC_FLOOR, np.abs(w) > SC_FLOOR,
                                          err_msg=f"leaf {i}")
            rel = SC_GRAD_REL if top >= SC_VALUE_SCALE else SC_SCALE_PATH_REL
            assert np.abs(g - w).max() <= rel * top, f"leaf {i}: {np.abs(g - w).max() / top}"


def assert_train_steps_match(name: str, quant: str, steps: int = 2) -> None:
    """`steps` make_train_step steps (warmup_steps=1, so step 2 runs at lr > 0) against
    the reference's jitted step: loss, lr and grad_norm each step."""
    from repro.optim import adamw_init as j_adamw_init
    from repro.train.step import make_train_step as j_make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    jcfg, jp = jax_params(name)
    _, cfg = configs(name)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    j_step = jax.jit(j_make_train_step(jcfg, policy=JPolicy(quant=quant), **kw))
    step = make_train_step(cfg, policy=ExecutionPolicy(quant=quant), **kw)
    js = j_adamw_init(jp)
    params = lm_from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state = adamw_init(params)
    for i in range(steps):
        batch = family_batch(cfg, 2, 32, seed=10 + i)
        jp, js, jm = j_step(jp, js, jax.tree.map(jnp.asarray, batch))
        out, state, m = step(params, state, torch_batch(batch))
        assert out is params and set(m) == {"loss", "grad_norm", "lr"}
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_LOSS_ATOL[quant], i
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-3 if quant == "none" else 2e-2)
    assert float(m["lr"]) > 0 and int(state.step) == int(js.step) == steps


def byte_identical(a, b) -> None:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def assert_bridge_round_trip(name: str, dtype: str) -> None:
    """The reference's params through lm_from_jax_params and back, byte for byte; the
    port's parameter count is the reference's."""
    from repro.models import nn as j_nn
    from repro_torch.models import nn as t_nn
    from repro_torch.params import lm_to_jax_params

    jcfg, jp = jax_params(name, dtype=dtype, seed=3)
    _, cfg = configs(name, dtype=dtype)
    tree = jax.tree.map(np.asarray, jp)
    module = lm_from_jax_params(tree, cfg, device="cpu")
    assert t_nn.count_params(module) == j_nn.count_params(tree)
    byte_identical(lm_to_jax_params(module), tree)


def assert_checkpoint_bytes(name: str, tmp_path) -> None:
    """The reference's bf16 train state after one update, copied into the port's
    (lm_state_from_tree) and saved: the port's checkpoint file is the reference's,
    byte for byte, and each package restores the other's bit for bit."""
    from repro.checkpoint import load_checkpoint as j_load
    from repro.checkpoint import save_checkpoint as j_save
    from repro.optim import adamw_init as j_adamw_init
    from repro.optim import adamw_update as j_adamw_update
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.train import LMCheckpoints
    from repro_torch.models.families import get_family_api
    from repro_torch.optim import adamw_init
    from repro_torch.params import _leaf_to_torch, lm_state_from_tree, lm_state_to_tree, tree_leaves

    jcfg, jp = jax_params(name, dtype="bfloat16")
    _, cfg = configs(name, dtype="bfloat16")
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jp)
    jp1, js1, _ = jax.jit(lambda g, p: j_adamw_update(g, j_adamw_init(p), p, lr=1e-3))(grads, jp)
    jtree = {"params": jp1, "opt": js1}

    def fresh(seed):
        params = get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(seed),
                                             device="cpu")
        return {"params": params, "opt": adamw_init(params)}

    state = lm_state_from_tree(fresh(9), jax.tree.map(lambda x: _leaf_to_torch(np.asarray(x)),
                                                      jtree))
    j_save(str(tmp_path / "jax"), 3, jtree)
    save_checkpoint(str(tmp_path / "port"), 3, lm_state_to_tree(state))
    blobs = [(tmp_path / who / "step_000000000003" / "data.msgpack.zst").read_bytes()
             for who in ("jax", "port")]
    assert blobs[0] == blobs[1]
    other = fresh(11)
    restored, step, _ = LMCheckpoints(str(tmp_path / "jax")).restore_or_none(other)
    assert restored is other and step == 3
    for g, w in zip(tree_leaves(lm_state_to_tree(other)), jax.tree.leaves(jtree)):
        assert _f32(_host(g)).tobytes() == _f32(np.asarray(w)).tobytes()
    back, step, _ = j_load(str(tmp_path / "port"), {"params": jp, "opt": j_adamw_init(jp)})
    assert step == 3
    byte_identical(jax.tree.map(np.asarray, back), jax.tree.map(np.asarray, jtree))


def assert_cli_trains(name: str, root, tmp_path) -> None:
    """`python -m repro_torch.launch.train --arch <name> --smoke --steps 3 --device cpu
    --ckpt-dir ...` runs, logs finite losses and leaves a checkpoint the reference
    reads."""
    import os
    import subprocess
    import sys

    from repro.checkpoint import load_checkpoint as j_load
    from repro.optim import adamw_init as j_adamw_init
    from repro_torch.checkpoint import latest_step

    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(str(root), "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", name, "--smoke",
           "--steps", "3", "--batch", "2", "--seq", "32", "--device", "cpu",
           "--ckpt-dir", str(ckpt)]
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 2"]
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0])) for ln in lines)
    assert latest_step(str(ckpt)) == 3
    _, jp = jax_params(name)
    tree, step, _ = j_load(str(ckpt), {"params": jp, "opt": j_adamw_init(jp)})
    assert step == 3 and int(tree["opt"].step) == 3
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(tree))
