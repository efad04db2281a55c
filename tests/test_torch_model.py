"""Port parity, model: the layers, the weight bridge and the whole pointnet2-cls
smoke forward against the JAX package, plus the accelerator entry point.

Tolerances and why:
  * float layers — torch's CPU matmul and XLA's sum products in different
    orders, and the LayerNorm variance is reduced in different orders
    (~1e-7 relative a layer); checked at atol 1e-5;
  * SC layers on identical float inputs are bitwise;
  * whole-forward SC logits — the float differences above can move an
    activation across one rounding boundary of the 16-bit quantizer (one
    quantum = max|x| / 32767), so logits may differ by a few quanta;
    checked at atol 1e-3 (observed ~6e-5 on logits of magnitude ~0.7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_smoke_config
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import nn as jnn
from repro.models import pointnet2 as JPN
from repro_torch.configs import get_config
from repro_torch.configs.pointnet2_cls import smoke_config
from repro_torch.core import accelerator as TA
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import nn as tnn
from repro_torch.models import pointnet2 as TPN
from repro_torch.params import from_jax_params

jax.config.update("jax_platform_name", "cpu")

FLOAT_ATOL = 1e-5
SC_LOGIT_ATOL = 1e-3


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def bridged():
    """Reference params from repro's init_params, carried over to the port."""
    jp = JPN.init_params(jax.random.PRNGKey(0), j_smoke_config())
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), smoke_config(), device="cpu")


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3, 256, 3)).astype(np.float32)
    pts[1] = np.round(pts[1] * 4) / 4  # a tie-heavy cloud
    return pts


def _linear_tree(rng, d_in, d_out):
    return {"w": (rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(np.float32),
            "b": rng.normal(size=(d_out,)).astype(np.float32)}


def _torch_linear(tree):
    lin = tnn.Linear(*tree["w"].shape)
    with torch.no_grad():
        lin.w.copy_(torch.from_numpy(tree["w"]))
        lin.b.copy_(torch.from_numpy(tree["b"]))
    return lin


# -- layers ------------------------------------------------------------------------


def test_linear_float_and_sc():
    rng = np.random.default_rng(1)
    tree = _linear_tree(rng, 35, 24)
    x = rng.normal(size=(2, 50, 35)).astype(np.float32)
    lin = _torch_linear(tree)
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
        want = _np(jnn.linear(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
        for quant in ("sc_w16a16", "sc_w8a8"):
            got = lin(torch.from_numpy(x), policy=ExecutionPolicy(quant=quant, backend="auto"))
            want = jnn.linear(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                              policy=JPolicy(quant=quant, backend="xla"))
            np.testing.assert_array_equal(got.numpy(), _np(want))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 9, 64)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    ln = tnn.LayerNorm(64)
    with torch.no_grad():
        ln.g.copy_(torch.from_numpy(g))
        ln.b.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x)).numpy()
    want = jnn.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(got, _np(want), rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("final_act", [True, False])
def test_mlp_matches_reference(final_act):
    jp = jnn.mlp_init(jax.random.PRNGKey(3), [6, 32, 16], norm=True)
    mlp = tnn.MLP([6, 32, 16])
    with torch.no_grad():
        for layer, leaf in zip(mlp.layers, jp["layers"]):
            layer.lin.w.copy_(torch.from_numpy(np.array(leaf["lin"]["w"])))
            layer.lin.b.copy_(torch.from_numpy(np.array(leaf["lin"]["b"])))
        x = np.random.default_rng(4).normal(size=(70, 6)).astype(np.float32)
        got = mlp(torch.from_numpy(x), final_act=final_act).numpy()
    want = jnn.mlp_apply(jp, jnp.asarray(x), final_act=final_act)
    np.testing.assert_allclose(got, _np(want), rtol=0, atol=FLOAT_ATOL)


# -- weight bridge ---------------------------------------------------------------------


def test_bridge_keeps_the_reference_layout(bridged):
    """JAX stores w as (d_in, d_out) with y = x @ w; the port keeps that layout."""
    jp, tp = bridged
    first = tp.sa[0].layers[0]
    np.testing.assert_array_equal(first.lin.w.detach().numpy(), _np(jp["sa"][0]["layers"][0]["lin"]["w"]))
    assert tuple(first.lin.w.shape) == (3, 32)
    np.testing.assert_array_equal(tp.head.layers[-1].lin.w.detach().numpy(),
                                  _np(jp["head"]["layers"][-1]["lin"]["w"]))
    np.testing.assert_array_equal(tp.global_mlp.layers[1].ln.g.detach().numpy(),
                                  _np(jp["global"]["layers"][1]["ln"]["g"]))
    assert all(layer.ln is None for layer in tp.head.layers)
    n_ref = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref


def test_bridge_rejects_mismatched_trees(bridged):
    jp, _ = bridged
    tree = jax.tree.map(np.asarray, jp)
    tree["sa"][0]["layers"][0]["lin"]["w"] = np.zeros((32, 3), np.float32)  # transposed
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, smoke_config(), device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["sa"] = tree["sa"][:1]
    with pytest.raises(ValueError):
        from_jax_params(tree, smoke_config(), device="cpu")


# -- whole forward -----------------------------------------------------------------------


@pytest.mark.parametrize("quant,atol", [("none", FLOAT_ATOL), ("sc_w16a16", SC_LOGIT_ATOL)])
def test_forward_logits_match_reference(bridged, clouds, quant, atol):
    jp, tp = bridged
    want = JPN.forward(jp, j_smoke_config(), jnp.asarray(clouds),
                       policy=JPolicy(quant=quant, backend="xla"))
    accel = TA.get_accelerator(smoke_config(), ExecutionPolicy(quant=quant), device="cpu")
    got = accel.infer(tp, clouds)
    assert got.shape == (3, 8) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=atol)


def test_preprocess_stage_matches_reference(clouds):
    want = JPN.preprocess_stage(j_smoke_config(), jnp.asarray(clouds), JPolicy(backend="xla"))
    got = TA.get_accelerator(smoke_config(), device="cpu").preprocess_stage(clouds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.centroid_idx.numpy(), _np(w.centroid_idx))
        np.testing.assert_array_equal(g.neighbors.idx.numpy(), _np(w.neighbors.idx))
        np.testing.assert_array_equal(g.neighbors.mask.numpy(), _np(w.neighbors.mask))


# -- accelerator entry point ----------------------------------------------------------------


def test_stages_compose_to_infer(bridged, clouds):
    _, tp = bridged
    accel = TA.get_accelerator(smoke_config(), ExecutionPolicy(quant="sc_w16a16"), device="cpu")
    pre = accel.preprocess_stage(clouds)
    assert torch.equal(accel.feature_stage(tp, clouds, pre), accel.infer(tp, clouds))
    out = accel.forward(tp, torch.from_numpy(clouds))
    assert out.requires_grad and torch.equal(out.detach(), accel.infer(tp, clouds))


def test_accelerator_cache_keys_config_policy_device():
    TA.clear_cache()
    cfg = smoke_config()
    a = TA.get_accelerator(cfg, device="cpu")
    assert TA.get_accelerator(cfg, ExecutionPolicy(), device="cpu") is a  # resolves alike
    b = TA.get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device="cpu")
    assert b is not a and b.policy.backend == "auto"
    stats = TA.cache_stats()
    assert (stats.hits, stats.misses, stats.size) == (1, 2, 2)
    assert ("pointnet2-cls", "sc_w16a16", "auto", "sequential", None, "cpu") in stats.keys
    TA.clear_cache()
    assert TA.cache_stats().size == 0


def test_default_device_is_the_card():
    """Without a card the default device raises; nothing drifts to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.get_accelerator(smoke_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.PC2IMAccelerator(smoke_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({}, smoke_config())
    assert TA.resolve_device("cpu") == torch.device("cpu")


def test_init_is_seeded_and_config_checked():
    cfg = get_config("pointnet2-cls", smoke=True)
    a = TPN.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = TPN.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert get_config("pointnet2-cls").n_points == 1024
    with pytest.raises(KeyError):
        get_config("pointnet2-part")
    with pytest.raises(ValueError, match="not ported"):
        TA.PC2IMAccelerator(cfg.__class__(**{**cfg.__dict__, "task": "part"}), device="cpu")
    # the paper's comparison corners are ported: accepted
    for change in ({"aggregation": "standard"}, {"preproc": "baseline1"},
                   {"preproc": "baseline2"}):
        TA.PC2IMAccelerator(cfg.__class__(**{**cfg.__dict__, **change}), device="cpu")
