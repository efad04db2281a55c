"""Port parity, the paper's comparison paths: the engine's baseline1, baseline2
and pc2im pipelines (and pc2im with the ball query), and the pointnet2 cls and
seg smoke forwards in the five corners the main path does not take
(baseline1/standard, baseline2/standard, pc2im/standard, baseline1/delayed,
baseline2/delayed), each under float and SC W16A16, against the JAX package.

Tolerances and why:
  * preprocessing is bitwise (indices, masks, gathered coordinates): both
    packages compute the same float32 distances and break ties alike, and
    the batched engine equals the port's per-cloud loop bitwise;
  * float logits at atol 1e-5 and SC logits at atol 1e-3, as
    tests/test_torch_model.py states: torch's CPU matmul and XLA's sum
    products in different orders, and under SC such a difference can move
    an activation across one rounding boundary of the 16-bit quantizer;
  * the accelerator's entry points against each other are bitwise: they
    run the same composition.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.configs.pointnet2_seg import smoke_config as j_seg_smoke
from repro.core import engine as JE
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import pointnet2 as JPN
from repro_torch.configs import get_config
from repro_torch.configs.pointnet2_cls import smoke_config as t_cls_smoke
from repro_torch.configs.pointnet2_seg import smoke_config as t_seg_smoke
from repro_torch.core import accelerator as TA
from repro_torch.core import engine as TE
from repro_torch.core import partition as TPart
from repro_torch.core import preprocess as TPre
from repro_torch.core.engine import result_row, result_stack, result_to_host
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import pointnet2 as TPN
from repro_torch.params import from_jax_params

jax.config.update("jax_platform_name", "cpu")

QUANTS = {"none": 1e-5, "sc_w16a16": 1e-3}
# The corners the main path (pc2im/delayed) does not take.
CORNERS = [("baseline1", "standard"), ("baseline2", "standard"), ("pc2im", "standard"),
           ("baseline1", "delayed"), ("baseline2", "delayed")]
MODELS = {"cls": (j_cls_smoke, t_cls_smoke), "seg": (j_seg_smoke, t_seg_smoke)}


def _clouds(b: int = 3, n: int = 256, seed: int = 0) -> np.ndarray:
    """(b, n, 3): uniform, snapped (many ties) and planar (empty grid cells)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    pts[1] = np.round(pts[1] * 4) / 4
    pts[2, :, 2] = 0.25
    return pts


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def _results_equal(got, want) -> None:
    _eq(got.centroid_idx, want.centroid_idx)
    _eq(got.centroid_xyz, want.centroid_xyz)
    _eq(got.neighbors.idx, want.neighbors.idx)
    _eq(got.neighbors.mask, want.neighbors.mask)
    _eq(got.centroid_valid, want.centroid_valid)


def _stack(results):
    return TPre.PreprocessResult(
        torch.stack([r.centroid_idx for r in results]),
        torch.stack([r.centroid_xyz for r in results]),
        TPre.NeighborSet(torch.stack([r.neighbors.idx for r in results]),
                         torch.stack([r.neighbors.mask for r in results])),
        torch.stack([r.centroid_valid for r in results]),
    )


def _per_cloud(cfg: TE.EngineConfig, cloud: torch.Tensor):
    """The port's per-cloud oracle of one engine config."""
    if cfg.pipeline == "baseline1":
        return TPre.preprocess_baseline1(cloud, cfg.n_centroids, cfg.radius, cfg.nsample)
    if cfg.pipeline == "baseline2":
        return TPre.preprocess_baseline2(cloud, cfg.n_centroids, cfg.radius, cfg.nsample,
                                         grid=cfg.grid, capacity=cfg.capacity)
    part = TPart.median_partition(cloud, cfg.depth, axis_mode=cfg.axis_mode)
    return TPre._tiled_common(cloud, part, cfg.n_centroids, cfg.radius, cfg.nsample,
                              cfg.resolved_metric, cfg.resolved_query)


# -- the engine ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["cls", "seg"])
@pytest.mark.parametrize("pipeline,query", [("baseline1", None), ("baseline2", None),
                                            ("pc2im", None), ("pc2im", "ball")])
def test_engine_stages_bitwise(model, pipeline, query):
    """Both smoke SA stages, chained: batched engine = per-cloud loop = JAX engine."""
    cfg = MODELS[model][1]()
    pts = _clouds(seed=3)
    xyz_j, xyz_t = jnp.asarray(pts), torch.from_numpy(pts)
    for sa in cfg.sa:
        kw = dict(pipeline=pipeline, query=query, n_centroids=sa.n_centroids,
                  radius=sa.radius, nsample=sa.nsample)
        if pipeline == "pc2im":
            kw["depth"] = TE.clamp_depth(xyz_t.shape[1], sa.n_centroids, cfg.msp_depth)
        teng = TE.PreprocessEngine(TE.EngineConfig(**kw))
        got = teng(xyz_t)
        want = JE.PreprocessEngine(JE.EngineConfig(backend="xla", **kw))(xyz_j)
        _results_equal(got, want)
        _results_equal(got, _stack([_per_cloud(teng.config, c) for c in xyz_t]))
        xyz_j, xyz_t = want.centroid_xyz, got.centroid_xyz


def test_engine_configs_and_validation():
    """Per-pipeline defaults as the reference's; every pipeline accepted, unknowns refused."""
    for pipeline, metric, query, tiles in [("pc2im", "l1", "lattice", 8),
                                           ("baseline1", "l2", "ball", 1),
                                           ("baseline2", "l2", "ball", 8)]:
        tc, jc = TE.EngineConfig(pipeline=pipeline), JE.EngineConfig(pipeline=pipeline)
        assert (tc.resolved_metric, tc.resolved_query, tc.n_tiles) == (metric, query, tiles)
        assert (jc.resolved_metric, jc.resolved_query, jc.n_tiles) == (metric, query, tiles)
        TE.PreprocessEngine(tc)
    assert TE.EngineConfig(pipeline="baseline2", grid=3).n_tiles == 27
    TE.PreprocessEngine(TE.EngineConfig(pipeline="pc2im", query="ball"))
    with pytest.raises(ValueError, match="unknown pipeline"):
        TE.PreprocessEngine(TE.EngineConfig(pipeline="baseline3"))
    with pytest.raises(ValueError, match="unknown pipeline"):
        JE.PreprocessEngine(JE.EngineConfig(pipeline="baseline3"))
    with pytest.raises(ValueError):
        TE.PreprocessEngine(TE.EngineConfig(query="cube"))
    # baseline1 and baseline2 take any N; a single cloud comes back unbatched
    one = torch.from_numpy(_clouds(3, 100, seed=4)[1])
    for pipeline in ("baseline1", "baseline2"):
        res = TE.get_engine(TE.EngineConfig(pipeline=pipeline, n_centroids=16, nsample=8))(one)
        assert tuple(res.neighbors.idx.shape) == (16, 8)


def test_baseline2_invalid_centroids_on_a_planar_cloud():
    """A planar cloud leaves half the 2^3 cells empty: their centroids are padding."""
    pts = torch.from_numpy(_clouds(seed=5))
    res = TE.PreprocessEngine(TE.EngineConfig(pipeline="baseline2", n_centroids=64))(pts)
    assert res.centroid_valid[0].all() and not res.centroid_valid[2].all()
    assert not res.neighbors.mask[2][~res.centroid_valid[2]].any()


# -- the model -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    """Per model: the reference params and the port's copy (from_jax_params)."""
    out = {}
    for model, (jcfg, tcfg) in MODELS.items():
        jp = JPN.init_params(jax.random.PRNGKey(0), jcfg())
        out[model] = jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg(), device="cpu")
    return out


def test_check_ported_accepts_every_corner():
    for model in ("cls", "seg"):
        base = get_config(f"pointnet2-{model}")
        for preproc in ("baseline1", "baseline2", "pc2im"):
            for aggregation in ("standard", "delayed"):
                TPN.check_ported(dataclasses.replace(base, preproc=preproc,
                                                     aggregation=aggregation))
    with pytest.raises(ValueError, match="aggregation"):
        cfg = dataclasses.replace(t_cls_smoke(), aggregation="mean")
        TA.PC2IMAccelerator(cfg, device="cpu").infer(
            TPN.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), _clouds())


@pytest.mark.parametrize("model", ["cls", "seg"])
def test_params_do_not_depend_on_the_corner(bridged, model):
    """The parameter tree is the same in every corner: the bridge gives equal weights."""
    jp, base = bridged[model]
    tree = jax.tree.map(np.asarray, jp)
    for preproc, aggregation in CORNERS:
        cfg = dataclasses.replace(MODELS[model][1](), preproc=preproc, aggregation=aggregation)
        other = from_jax_params(tree, cfg, device="cpu")
        for (na, a), (nb, b) in zip(base.named_parameters(), other.named_parameters()):
            assert na == nb and torch.equal(a, b)
        fresh = TPN.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        assert [p.shape for p in fresh.parameters()] == [p.shape for p in base.parameters()]


@pytest.mark.parametrize("model", ["cls", "seg"])
@pytest.mark.parametrize("preproc,aggregation", CORNERS)
@pytest.mark.parametrize("quant", list(QUANTS))
def test_corner_forward_matches_reference(bridged, model, preproc, aggregation, quant):
    jp, tp = bridged[model]
    jcfg, tcfg = (dataclasses.replace(f(), preproc=preproc, aggregation=aggregation)
                  for f in MODELS[model])
    pts = _clouds()
    want = np.asarray(JPN.forward(jp, jcfg, jnp.asarray(pts),
                                  policy=JPolicy(quant=quant, backend="xla")))
    accel = TA.get_accelerator(tcfg, ExecutionPolicy(quant=quant), device="cpu")
    got = accel.infer(tp, pts)
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=QUANTS[quant])
    # the preprocessing leaves: bitwise against the reference's
    for g, w in zip(accel.preprocess_stage(pts),
                    JPN.preprocess_stage(jcfg, jnp.asarray(pts), JPolicy(backend="xla"))):
        _results_equal(g, w)


@pytest.mark.parametrize("model", ["cls", "seg"])
@pytest.mark.parametrize("preproc,aggregation", CORNERS)
def test_entry_points_agree_bitwise(bridged, model, preproc, aggregation):
    """infer, infer_with_preprocess and feature_from_cached (cache rows, a zero filler row)."""
    _, tp = bridged[model]
    cfg = dataclasses.replace(MODELS[model][1](), preproc=preproc, aggregation=aggregation)
    accel = TA.get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device="cpu")
    pts = _clouds(seed=6)
    logits, pre = accel.infer_with_preprocess(tp, pts)
    assert torch.equal(logits, accel.infer(tp, pts))
    assert torch.equal(accel.feature_stage(tp, pts, pre), logits)
    host = result_to_host(pre)
    assert torch.equal(accel.feature_from_cached(tp, pts, host), logits)
    # the padded batch of a serving all-hit path: two real rows, a zero filler cloud
    padded = pts.copy()
    padded[2] = 0.0
    want, filler_pre = accel.infer_with_preprocess(tp, padded)
    filler = result_row(result_to_host(filler_pre), 2)
    if preproc == "baseline2":
        assert not filler[0].centroid_valid.all()  # the zero cloud fills one cell
    stacked = result_stack([result_row(host, 0), result_row(host, 1)], total=3, filler=filler)
    got = accel.feature_from_cached(tp, padded, stacked)
    assert torch.equal(got, want)
