"""Port parity, LM training: `chunked_cross_entropy`, `lm_loss`, its gradients,
`make_train_step` and microbatching against the JAX package, on the dense
smoke configs.

The reference's params come through `params.lm_from_jax_params`; tokens are
numpy draws handed to both packages; the reference runs jitted, as its
trainer runs it.  A sequence of 48 tokens makes every config's chunk of 32
halve to 16 (the reference's chunk rule).

Tolerances and why (measured on this host's CPU in brackets):
  * float32 loss atol 1e-5 [<= 9.6e-7] and gradients within 1e-5 of each
    leaf's max |g| [<= 3.5e-6]: the matmuls, softmaxes and norms sum in
    other orders (~1e-7 relative an op);
  * SC W16A16 loss atol 1e-3 [<= 9.6e-7] and gradients by
    tests/test_torch_train.py's rule: a weight's gradient reaches it only
    through the two quantizer scales (round and the int32 cast cut the rest,
    in both packages), so the nonzero pattern above 1e-30 must be equal,
    and each value within 1e-3 of the leaf's max where that max is at
    least 1e-3, 2e-2 below it (such a leaf's gradient passes through the
    amax of later layers' inputs, where one-quantum differences do not
    cancel) [<= 4.7e-4 of the leaf's max];
  * three steps: each step's loss within 1e-4 (float) / 1e-3 (SC) of the
    reference's jitted step, as tests/test_torch_train.py holds its steps;
  * microbatch=4, two steps (the second at lr > 0, its update ~1e-3 a
    parameter), against the reference's microbatched step and against the
    whole batch: the reference's own bounds (tests/test_integration.py):
    loss 1e-4, parameters rtol 5e-4, atol 5e-5 [<= 2.7e-7 vs the reference,
    3.0e-8 vs the whole batch], and the gradient norm rtol 1e-3 [<= 6.3e-8].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import families
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.params import (_lm_tree, lm_from_jax_params, lm_to_jax_params,
                                named_jax_params, tree_leaves)
from repro_torch.train import make_train_step

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

DENSE = ["stablelm-1.6b", "starcoder2-3b", "gemma3-12b"]
LOSS_ATOL = {"none": 1e-5, "sc_w16a16": 1e-3}
FLOAT_GRAD_REL = 1e-5
SC_FLOOR = 1e-30
SC_GRAD_REL, SC_VALUE_SCALE, SC_SCALE_PATH_REL = 1e-3, 1e-3, 2e-2
STEP_LOSS_ATOL = {"none": 1e-4, "sc_w16a16": 1e-3}
MICRO_LOSS_ATOL, MICRO_RTOL, MICRO_ATOL = 1e-4, 5e-4, 5e-5
MICRO_GRAD_NORM_RTOL = 1e-3
# (config, quant) of the gradient cases: every dense smoke config in float
# (LayerNorm, the dense MLP and biases in starcoder2; tied embeddings and
# windows in gemma3), SC W16A16 on stablelm
GRAD_CASES = [(n, "none") for n in DENSE] + [("stablelm-1.6b", "sc_w16a16")]


def _batch(vocab: int, b: int, s: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def refs():
    """Per gradient case: the reference's params, a batch, its jitted loss and gradients."""
    out = {}
    for name, quant in GRAD_CASES:
        jcfg = j_get_config(name, smoke=True)
        jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        batch = _batch(jcfg.vocab_size, 2, 48, seed=1)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, c=jcfg, q=quant: JT.lm_loss(p, c, b, policy=JPolicy(quant=q)),
            has_aux=True))
        (loss, _), grads = fn(jp, jax.tree.map(jnp.asarray, batch))
        out[name, quant] = dict(tree=jax.tree.map(np.asarray, jp), batch=batch,
                                loss=float(loss), grads=[np.asarray(g) for g in
                                                         jax.tree.leaves(grads)])
    return out


def _port(name, tree):
    cfg = get_config(name, smoke=True)
    return cfg, lm_from_jax_params(tree, cfg, device="cpu")


def test_chunked_cross_entropy_matches_reference():
    """A chunk of 32 over 48 positions halves to 16; a mask with zeros divides by
    its own count; an all-zero mask divides by 1.  Against the reference's, and
    against the CE of the whole (B, S, V) logits."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 48, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 40)) / 5).astype(np.float32)
    labels = rng.integers(0, 40, (3, 48)).astype(np.int32)
    mask = (rng.uniform(size=(3, 48)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = JT.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                        chunk=32, mask=None if m is None else jnp.asarray(m))
        got = T.chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                      torch.from_numpy(labels), chunk=32,
                                      mask=None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= LOSS_ATOL["none"]
    whole = torch.nn.functional.cross_entropy(
        (torch.from_numpy(h) @ torch.from_numpy(w)).reshape(-1, 40),
        torch.from_numpy(labels).reshape(-1).long())
    got = T.chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(labels), chunk=32)
    assert abs(float(got) - float(whole)) <= LOSS_ATOL["none"]


@pytest.mark.parametrize("name,quant", GRAD_CASES)
def test_lm_loss_matches_reference(refs, name, quant):
    ref = refs[name, quant]
    cfg, params = _port(name, ref["tree"])
    loss, metrics = T.lm_loss(params, cfg, _torch(ref["batch"]),
                              policy=ExecutionPolicy(quant=quant))
    assert loss.shape == () and loss.dtype == torch.float32 and metrics["loss"] is loss
    assert loss.requires_grad
    assert abs(float(loss.detach()) - ref["loss"]) <= LOSS_ATOL[quant]
    api_loss, _ = families.get_family_api(cfg)["train_loss"](
        params, cfg, _torch(ref["batch"]), policy=ExecutionPolicy(quant=quant))
    assert torch.equal(api_loss, loss)


@pytest.mark.parametrize("name,quant", GRAD_CASES)
def test_gradients_match_reference(refs, name, quant):
    ref = refs[name, quant]
    cfg, params = _port(name, ref["tree"])
    named = named_jax_params(params)
    loss, _ = T.lm_loss(params, cfg, _torch(ref["batch"]), policy=ExecutionPolicy(quant=quant))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    got = tree_leaves(_lm_tree(grads, *T.group_geometry(cfg)))
    assert len(got) == len(ref["grads"])
    for i, (g, w) in enumerate(zip(got, ref["grads"])):
        g = g.numpy()
        assert g.shape == w.shape
        top = float(np.abs(w).max())
        if quant == "none":
            assert np.abs(g - w).max() <= FLOAT_GRAD_REL * top, f"leaf {i}"
            continue
        np.testing.assert_array_equal(np.abs(g) > SC_FLOOR, np.abs(w) > SC_FLOOR,
                                      err_msg=f"leaf {i}: nonzero pattern")
        if top > SC_FLOOR:
            rel = SC_GRAD_REL if top >= SC_VALUE_SCALE else SC_SCALE_PATH_REL
            assert np.abs(g - w).max() <= rel * top, f"leaf {i}: {np.abs(g - w).max() / top}"


def test_sc_gradient_reaches_a_weight_only_through_its_scale(refs):
    """Under SC a linear's weight gets one nonzero gradient, at its max |w|."""
    ref = refs["stablelm-1.6b", "sc_w16a16"]
    cfg, params = _port("stablelm-1.6b", ref["tree"])
    loss, _ = T.lm_loss(params, cfg, _torch(ref["batch"]), policy=ExecutionPolicy(quant="sc_w16a16"))
    w = params.blocks[1].mlp.wo.w
    (g,) = torch.autograd.grad(loss, [w])
    assert int((g != 0).sum()) == 1
    assert int(g.abs().flatten().argmax()) == int(w.detach().abs().flatten().argmax())


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_three_train_steps_match_reference(quant):
    name = "stablelm-1.6b"
    jcfg, cfg = j_get_config(name, smoke=True), get_config(name, smoke=True)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    j_step = jax.jit(j_make_train_step(jcfg, policy=JPolicy(quant=quant), **kw))
    step = make_train_step(cfg, policy=ExecutionPolicy(quant=quant), **kw)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    js = j_adamw_init(jp)
    params = lm_from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state = adamw_init(params)
    for i in range(3):
        batch = _batch(cfg.vocab_size, 4, 32, seed=10 + i)
        jp, js, jm = j_step(jp, js, jax.tree.map(jnp.asarray, batch))
        out, state, m = step(params, state, _torch(batch))
        assert out is params and set(m) == {"loss", "grad_norm", "lr"}
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_LOSS_ATOL[quant], i
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-3 if quant == "none" else 2e-2)
    assert int(state.step) == int(js.step) == 3


def test_microbatched_step_matches_one_batch():
    """microbatch=4 sums four float32 gradients and divides by 4.  Two steps, the
    second at lr > 0 (warmup_steps=1), against the reference's own microbatched
    (`scan`) step: the loss, the gradient norm and, after the second step, every
    parameter.  And against the whole batch within the reference's own
    test_integration.py bounds."""
    name = "stablelm-1.6b"
    jcfg, cfg = j_get_config(name, smoke=True), get_config(name, smoke=True)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [_batch(cfg.vocab_size, 8, 32, seed=3 + i) for i in range(2)]
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    ref = jax.tree.map(np.asarray, jp)
    j_step = jax.jit(j_make_train_step(jcfg, microbatch=4, **kw))
    js, j_metrics = j_adamw_init(jp), []
    for b in batches:
        jp, js, jm = j_step(jp, js, jax.tree.map(jnp.asarray, b))
        j_metrics.append(jm)
    runs = {}
    for micro in (None, 4):
        params = lm_from_jax_params(ref, cfg, device="cpu")
        step, state = make_train_step(cfg, microbatch=micro, **kw), adamw_init(params)
        runs[micro] = ([step(params, state, _torch(b))[2] for b in batches], params)
    (m1, p1), (m4, p4) = runs[None], runs[4]
    assert float(m4[1]["lr"]) > 0
    for i, (m, jm) in enumerate(zip(m4, j_metrics)):
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_LOSS_ATOL["none"], i
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=MICRO_GRAD_NORM_RTOL, err_msg=f"step {i}")
    want = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    got = tree_leaves(lm_to_jax_params(p4))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=MICRO_RTOL, atol=MICRO_ATOL, err_msg=f"leaf {i}")
    for a, b in zip(m1, m4):
        assert abs(float(a["loss"]) - float(b["loss"])) < MICRO_LOSS_ATOL
        np.testing.assert_allclose(float(a["grad_norm"]), float(b["grad_norm"]),
                                   rtol=MICRO_GRAD_NORM_RTOL)
    for a, b in zip(p1.parameters(), p4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=MICRO_RTOL,
                                   atol=MICRO_ATOL)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, microbatch=3)(p1, adamw_init(p1), _torch(batches[0]))


def test_bf16_step_keeps_a_float32_master_and_moves_it():
    """bf16 parameters train through adamw_init's float32 master copy; the
    reference's tree holds the same bf16 parameters after lm_to_jax_params."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True), dtype_str="bfloat16")
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = adamw_init(params)
    assert state.master is not None and all(v.dtype == torch.float32
                                            for v in state.master.values())
    before = {k: v.clone() for k, v in state.master.items()}
    _, _, m = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1)(
        params, state, _torch(_batch(cfg.vocab_size, 2, 32, seed=4)))
    _, _, m = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1)(
        params, state, _torch(_batch(cfg.vocab_size, 2, 32, seed=5)))
    assert bool(torch.isfinite(m["loss"])) and params.embed.dtype == torch.bfloat16
    assert any(not torch.equal(before[k], v) for k, v in state.master.items())
    for k, p in params.named_parameters():
        assert torch.equal(p.detach(), state.master[k].to(torch.bfloat16)), k
    assert lm_to_jax_params(params)["embed"].dtype.name == "bfloat16"
