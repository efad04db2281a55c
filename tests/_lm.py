"""Shared harness of the LM parity tests: one serving case run through the JAX
package and through the port on the same params and tokens.

A case is a dense smoke config with a quant policy, a KV-cache kind and a
dtype.  The JAX side initialises the reference's params, prefills a seeded
prompt and takes `steps` greedy decode steps, both jitted once; the port
gets the same params through `lm_from_jax_params` and is fed the
reference's greedy tokens (teacher forcing), so each step's logits compare
on the same inputs.  Its own `generate` runs too: in float32 its tokens
must be the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.params import lm_from_jax_params
from repro_torch.serve import make_serve_fns

BATCH, PROMPT, S_MAX, STEPS = 2, 16, 24, 3


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


def state_arrays(state) -> list[list[np.ndarray]]:
    """A DecodeState's caches (either package's) as numpy, slot by slot, then cache_len."""
    out = []
    for cache in state.caches:
        out.append([_f32(_host(t)) for t in cache])
    n = state.cache_len
    out.append([np.asarray(n.cpu().numpy() if torch.is_tensor(n) else n)])
    return out


def jax_case(name: str, quant: str, *, kv: str = "none", dtype: str | None = None,
             prompt: int = PROMPT, s_max: int = S_MAX, steps: int = STEPS, seed: int = 1) -> dict:
    """The reference's run of one case (params, tokens, logits, states, greedy tokens)."""
    jcfg, _ = configs(name, kv=kv, dtype=dtype)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    pol = JPolicy(quant=quant)
    pre = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, s_max, policy=pol))
    dec = jax.jit(lambda p, st, t: JT.decode_step(p, jcfg, st, t, policy=pol))
    logits, st = pre(jp, jnp.asarray(tokens))
    out = {"name": name, "quant": quant, "kv": kv, "dtype": dtype,
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
    with torch.no_grad():
        logits, st = fns["prefill"](params, {"tokens": ref["tokens"]}, ref["s_max"])
        out["prefill"], out["state0"] = _f32(logits.numpy()), state_arrays(st)
        for tok in ref["fed"][:len(ref["steps"])]:
            logits, _, st = fns["decode"](params, st, {"token": tok})
            out["steps"].append(_f32(logits.numpy()))
            out["states"].append(state_arrays(st))
        out["generate"] = fns["generate"](params, {"tokens": ref["tokens"]},
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
