"""Port parity, segmentation: the pointnet2-seg smoke forward against the JAX
package, the FP stages' 3-NN indices, the seg weight bridge and the config
checks.  Every JAX-side seg forward lives in this file, behind module-scoped
fixtures, so each policy's reference compiles once.

Tolerances and why:
  * preprocessing and the FP 3-NN indices are bitwise: both packages
    compute the same float32 distances and break ties the same way;
  * float logits at atol 1e-5: torch's CPU matmul and XLA's sum products in
    different orders (~1e-7 relative a layer; observed ~6e-7);
  * SC logits at atol 1e-3: those float differences can move an activation
    across one rounding boundary of the 16-bit quantizer (one quantum is
    max|x| / 32767), so logits may differ by a few quanta (observed ~2e-4
    on logits of magnitude ~0.9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_seg import smoke_config as j_smoke_config
from repro.core import query as JQuery
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro_torch.configs import get_config
from repro_torch.configs.pointnet2_seg import smoke_config
from repro_torch.core import accelerator as TA
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.kernels.knn3.ops import knn3
from repro_torch.models import pointnet2 as TPN
from repro_torch.params import from_jax_params

jax.config.update("jax_platform_name", "cpu")

FLOAT_ATOL = 1e-5
SC_LOGIT_ATOL = 1e-3
QUANTS = {"none": FLOAT_ATOL, "sc_w16a16": SC_LOGIT_ATOL}


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def bridged():
    """Reference seg params from repro's init_params, carried over to the port."""
    jp = JPN.init_params(jax.random.PRNGKey(0), j_smoke_config())
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), smoke_config(), device="cpu")


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3, 256, 3)).astype(np.float32)
    pts[1] = np.round(pts[1] * 4) / 4  # a tie-heavy cloud
    return pts


@pytest.fixture(scope="module")
def reference_logits(bridged, clouds):
    """The JAX package's seg logits under each policy, computed once."""
    jp, _ = bridged
    return {
        quant: _np(JPN.forward(jp, j_smoke_config(), jnp.asarray(clouds),
                               policy=JPolicy(quant=quant, backend="xla")))
        for quant in QUANTS
    }


@pytest.mark.parametrize("quant", list(QUANTS))
def test_forward_logits_match_reference(bridged, clouds, reference_logits, quant):
    _, tp = bridged
    accel = TA.get_accelerator(get_config("pointnet2-seg", smoke=True),
                               ExecutionPolicy(quant=quant), device="cpu")
    got = accel.infer(tp, clouds)
    assert got.shape == (3, 256, 8) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), reference_logits[quant], rtol=0, atol=QUANTS[quant])


def test_preprocessing_and_fp_knn_indices_bitwise(clouds):
    """The SA stages' preprocessing, then each FP stage's 3-NN (fine level
    among the next coarser one, as the forward walks them), bitwise."""
    want = JPN.preprocess_stage(j_smoke_config(), jnp.asarray(clouds), JPolicy(backend="xla"))
    got = TA.get_accelerator(smoke_config(), device="cpu").preprocess_stage(clouds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.centroid_idx.numpy(), _np(w.centroid_idx))
        np.testing.assert_array_equal(g.centroid_xyz.numpy(), _np(w.centroid_xyz))
        np.testing.assert_array_equal(g.neighbors.idx.numpy(), _np(w.neighbors.idx))
        np.testing.assert_array_equal(g.neighbors.mask.numpy(), _np(w.neighbors.mask))
    levels = [clouds] + [np.array(w.centroid_xyz) for w in want]  # writable copies
    for fine, coarse in zip(levels[:-1], levels[1:]):
        wi, wd = jax.vmap(lambda q, r: JQuery.knn(q, r, 3))(jnp.asarray(fine), jnp.asarray(coarse))
        gi, gd = knn3(torch.from_numpy(fine), torch.from_numpy(coarse))
        assert gi.shape == fine.shape[:2] + (3,)
        np.testing.assert_array_equal(gi.numpy(), _np(wi))
        np.testing.assert_array_equal(gd.numpy(), _np(wd))


def test_stages_compose_to_infer(bridged, clouds):
    _, tp = bridged
    accel = TA.get_accelerator(smoke_config(), ExecutionPolicy(quant="sc_w16a16"), device="cpu")
    pre = accel.preprocess_stage(clouds)
    assert torch.equal(accel.feature_stage(tp, clouds, pre), accel.infer(tp, clouds))
    out = accel.forward(tp, torch.from_numpy(clouds))
    assert out.requires_grad and torch.equal(out.detach(), accel.infer(tp, clouds))


# -- weight bridge and config checks ------------------------------------------------


def test_bridge_reads_the_seg_tree(bridged):
    """fp[i] and head come over as they are; no global MLP; every leaf counted."""
    jp, tp = bridged
    assert not hasattr(tp, "global_mlp") and len(tp.fp) == 2
    # FP0: 128 coarse + 64 skip -> 64 -> 64; FP1: 64 + 3 xyz -> 64 -> 64; head 64 -> 64 -> 8
    assert [tuple(m.layers[0].lin.w.shape) for m in tp.fp] == [(192, 64), (67, 64)]
    assert [tuple(layer.lin.w.shape) for layer in tp.head.layers] == [(64, 64), (64, 8)]
    for i, mlp in enumerate(tp.fp):
        for j, layer in enumerate(mlp.layers):
            leaf = jp["fp"][i]["layers"][j]
            np.testing.assert_array_equal(layer.lin.w.detach().numpy(), _np(leaf["lin"]["w"]))
            np.testing.assert_array_equal(layer.ln.b.detach().numpy(), _np(leaf["ln"]["b"]))
    assert all(layer.ln is None for layer in tp.head.layers)
    n_ref = sum(x.size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref


@pytest.mark.parametrize("fault", ["fp_transposed", "fp_short", "head_wide", "no_fp"])
def test_bridge_rejects_mismatched_seg_trees(bridged, fault):
    jp, _ = bridged
    tree = jax.tree.map(np.asarray, jp)
    if fault == "fp_transposed":
        tree["fp"][1]["layers"][0]["lin"]["w"] = np.zeros((64, 67), np.float32)
    elif fault == "fp_short":
        tree["fp"] = tree["fp"][:1]
    elif fault == "head_wide":
        tree["head"]["layers"][-1]["lin"]["b"] = np.zeros((9,), np.float32)
    else:
        del tree["fp"]
    with pytest.raises((ValueError, KeyError)):
        from_jax_params(tree, smoke_config(), device="cpu")


@pytest.mark.parametrize("change", [{"task": "part"}, {"task": "det"},
                                    {"task": "part", "preproc": "baseline2"}])
def test_check_ported_refuses_the_rest(change):
    cfg = smoke_config()
    with pytest.raises(ValueError, match="not ported"):
        TA.PC2IMAccelerator(cfg.__class__(**{**cfg.__dict__, **change}), device="cpu")


def test_seg_config_and_default_device():
    cfg = get_config("pointnet2-seg")
    assert (cfg.task, cfg.n_points, cfg.msp_depth, cfg.fp_mlp) == ("seg", 4096, 3, (256, 128))
    assert smoke_config().n_points == 256
    params = TPN.init_params(smoke_config(), torch.Generator().manual_seed(1), device="cpu")
    assert all(p.device.type == "cpu" for p in params.parameters())
    if torch.cuda.is_available():
        default = TPN.init_params(smoke_config(), torch.Generator().manual_seed(1))
        assert all(p.device.type == "cuda" for p in default.parameters())
    else:  # the default device is the card; without one it raises
        with pytest.raises(RuntimeError, match="CUDA"):
            TPN.init_params(smoke_config())
        with pytest.raises(RuntimeError, match="CUDA"):
            TPN.PointNet2Params(smoke_config())
