"""Port parity, sharded artifacts on the CPU: `mesh_artifacts(("cpu",) * g).infer`
for pointnet2-cls and pointnet2-seg (smoke configs) under {none, sc_w16a16}
x {batch, tensor} x g in {2, 4} (and 8 for cls), against the port's own
single-device `infer` of the same batch and against the JAX package's
single-device forward with the same (bridged) weights.

The reference's own sharded tests cannot run on the installed jax (its
replica axis reads `jax.core.axis_frame`, which is gone), so the sharded
artifacts are held to the reference's stated contract: bitwise equal to
single-device `infer`.

Tolerances and why:
  * against the port's `infer`: bitwise.  Batch mode runs each row's math
    unchanged, with the SC activation scale made global by an exact max;
    tensor mode quantizes the full weight and slices its integer columns,
    and a float column block or row block of torch's CPU matmul equals the
    same block of the full product.  One exception, at g = 8 in float:
    the cls head then multiplies one row (batch: one cloud a shard) and the
    tensor split leaves one column of the 8-class head (cls and seg), and
    MKL computes a one-row or one-column product as a matrix-vector product
    (gemv), which sums K in another order than the matrix product (gemm)
    of the unsharded batch.  Those cases are held at 1e-5 (observed 2.4e-7
    to 7.2e-7) and everything else stays bitwise, SC at g = 8 too;
  * against the JAX package: float at atol 1e-5, SC at atol 1e-3, the
    bounds tests/test_torch_seg.py states (torch's CPU matmul and XLA sum
    in different orders, and under SC that can move an activation across
    one quantizer boundary).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.configs.pointnet2_seg import smoke_config as j_seg_smoke
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro_torch.configs import get_config
from repro_torch.core.accelerator import get_accelerator, params_device, place_on_group
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.params import from_jax_params
from repro_torch.sharding import hints

jax.config.update("jax_platform_name", "cpu")

B = 8
JAX_ATOL = {"none": 1e-5, "sc_w16a16": 1e-3}
GEMV_ATOL = 1e-5
GROUPS = {"cls": (2, 4, 8), "seg": (2, 4)}
J_CONFIGS = {"cls": j_cls_smoke, "seg": j_seg_smoke}


def _gemv_case(model: str, quant: str, mode: str, g: int) -> bool:
    """Whether a float layer of this case becomes a one-row or one-column
    product where the unsharded batch has a matrix product (see the module doc)."""
    if quant != "none" or g < 8:
        return False
    return mode == "tensor" or model == "cls"


@pytest.fixture(scope="module")
def setup():
    """Per model: the port config, bridged params, 8 clouds (one tie-heavy),
    and the JAX package's logits under each policy, computed once."""
    out = {}
    rng = np.random.default_rng(0)
    for model, jcfg_fn in J_CONFIGS.items():
        cfg = get_config(f"pointnet2-{model}", smoke=True)
        jcfg = jcfg_fn()
        jp = JPN.init_params(jax.random.PRNGKey(1), jcfg)
        params = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        pts = rng.uniform(-1, 1, (B, cfg.n_points, 3)).astype(np.float32)
        pts[3] = np.round(pts[3] * 4) / 4
        ref = {q: np.asarray(JPN.forward(jp, jcfg, jnp.asarray(pts),
                                         policy=JPolicy(quant=q, backend="xla")))
               for q in JAX_ATOL}
        out[model] = (cfg, params, pts, ref)
    return out


CASES = [(m, q, mode, g) for m in ("cls", "seg") for q in ("none", "sc_w16a16")
         for mode in ("batch", "tensor") for g in GROUPS[m]]


@pytest.mark.parametrize("model,quant,mode,g", CASES,
                         ids=[f"{m}-{q}-{mode}-g{g}" for m, q, mode, g in CASES])
def test_sharded_infer_equals_single_device_infer(setup, model, quant, mode, g):
    cfg, params, pts, ref = setup[model]
    want = get_accelerator(cfg, ExecutionPolicy(quant=quant), device="cpu").infer(params, pts)
    arts = get_accelerator(cfg, ExecutionPolicy(quant=quant, sharding=mode),
                           device="cpu").mesh_artifacts(("cpu",) * g)
    got = arts.infer(params, pts)
    assert got.shape == want.shape and got.device == torch.device("cpu")
    if _gemv_case(model, quant, mode, g):
        torch.testing.assert_close(got, want, rtol=0, atol=GEMV_ATOL)
    else:
        assert torch.equal(got, want), (got - want).abs().max().item()
    np.testing.assert_allclose(got.numpy(), ref[quant], rtol=0, atol=JAX_ATOL[quant])
    assert torch.equal(arts.forward(params, pts), got)


def test_one_device_group_runs_the_unsharded_math(setup):
    cfg, params, pts, _ = setup["cls"]
    for q in ("none", "sc_w16a16"):
        want = get_accelerator(cfg, ExecutionPolicy(quant=q), device="cpu").infer(params, pts)
        for mode in ("batch", "tensor"):
            arts = get_accelerator(cfg, ExecutionPolicy(quant=q, sharding=mode),
                                   device="cpu").mesh_artifacts(("cpu",))
            assert torch.equal(arts.infer(params, pts), want)


def test_a_group_that_does_not_divide_the_batch_raises(setup):
    cfg, params, pts, _ = setup["cls"]
    arts = get_accelerator(cfg, ExecutionPolicy(sharding="batch"),
                           device="cpu").mesh_artifacts(("cpu",) * 3)
    with pytest.raises(ValueError, match="must divide"):
        arts.infer(params, pts)


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_tensor_mode_with_a_group_that_does_not_divide_the_widths(setup, quant):
    """g = 3 with B = 6: every layer width (8 to 1024, and the 8-class head)
    leaves pad columns on the last shard, dropped after the gather."""
    cfg, params, pts, ref = setup["cls"]
    want = get_accelerator(cfg, ExecutionPolicy(quant=quant), device="cpu").infer(params, pts[:6])
    got = get_accelerator(cfg, ExecutionPolicy(quant=quant, sharding="tensor"),
                          device="cpu").mesh_artifacts(("cpu",) * 3).infer(params, pts[:6])
    assert torch.equal(got, want)


def test_per_shard_params_and_tensor_points(setup):
    """One params module a shard, and points given as a tensor, as the pool passes them."""
    cfg, params, pts, _ = setup["seg"]
    pol = ExecutionPolicy(quant="sc_w16a16", sharding="tensor")
    want = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device="cpu").infer(params, pts)
    arts = get_accelerator(cfg, pol, device="cpu").mesh_artifacts(("cpu",) * 2)
    assert torch.equal(arts.infer((params, params), torch.from_numpy(pts)), want)
    with pytest.raises(ValueError, match="params modules"):
        arts.infer((params,), pts)


@pytest.mark.parametrize("mode", ["batch", "tensor"])
def test_params_updated_in_place_reach_the_next_call(setup, mode):
    """Weights loaded into the caller's module in place between two calls
    are what the second call computes with, as for single-device `infer`."""
    cfg, params, pts, _ = setup["cls"]
    params = copy.deepcopy(params)
    single = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device="cpu")
    arts = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16", sharding=mode),
                           device="cpu").mesh_artifacts(("cpu",) * 2)
    first = arts.infer(params, pts)
    params.load_state_dict(single.init(torch.Generator().manual_seed(9)).state_dict())
    got = arts.infer(params, pts)
    assert torch.equal(got, single.infer(params, pts))
    assert not torch.equal(got, first)


def test_place_on_group_copies_once_a_device_and_never_moves_the_caller(setup):
    """The caller's module serves the shards on its own device; every other
    device gets one fresh copy, shared by its shards, at each placement."""
    _, params, _, _ = setup["cls"]
    cpu, meta = torch.device("cpu"), torch.device("meta")
    placed = place_on_group(params, (cpu, meta, meta, cpu))
    assert placed[0] is params and placed[3] is params
    assert placed[1] is placed[2] and placed[1] is not params
    assert params_device(placed[1]) == meta and params_device(params) == cpu
    assert place_on_group(params, (meta,))[0] is not placed[1]


def test_batch_mode_needs_the_global_activation_scale(setup, monkeypatch):
    """Shards of very different magnitude (rows scaled by 1e3 on shard 0,
    by 1e-3 on shard 1): with the group's max the SC logits equal the
    single-device ones bitwise; with each shard's own amax (the max across
    shards patched out) they do not, so this test catches a local scale."""
    cfg, params, pts, _ = setup["cls"]
    skewed = pts.copy()
    skewed[:4] *= 1e3
    skewed[4:] *= 1e-3
    sc = ExecutionPolicy(quant="sc_w16a16")
    want = get_accelerator(cfg, sc, device="cpu").infer(params, skewed)
    arts = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16", sharding="batch"),
                           device="cpu").mesh_artifacts(("cpu",) * 2)
    assert torch.equal(arts.infer(params, skewed), want)
    monkeypatch.setattr(hints, "all_max", lambda x, axis_name=hints.REPLICA_AXIS: x)
    local = arts.infer(params, skewed)
    assert not torch.equal(local, want)
    assert (local - want).abs().max().item() > 1e-3
