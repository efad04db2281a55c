"""Port parity, the per-cloud oracles of the paper's comparison paths: the masked
and quantized FPS, the sampling-quality metrics, the Morton and grid
partitions, the ball query, the quant helpers and the three per-cloud
preprocessing pipelines, each held against the JAX package on the same
seeded numpy inputs (snapped clouds, with many ties, included).

Every index, mask and partition output is compared bitwise; so are the
floats that come from equal indices (gathered coordinates, the quantized
grid, the covering radius and the separation, which are a max/min of
bitwise-equal distances).  The two float means of `ptq_error` are reduced in
different orders by torch and XLA: held at rtol 1e-6 (float32 rounding of a
sum of a few thousand terms is ~1e-7 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.core import fps as JF
from repro.core import grouping as JGroup
from repro.core import partition as JPart
from repro.core import preprocess as JPre
from repro.core import quant as JQ
from repro.core import query as JQuery
from repro_torch.core import fps as TF
from repro_torch.core import grouping as TGroup
from repro_torch.core import partition as TPart
from repro_torch.core import preprocess as TPre
from repro_torch.core import quant as TQ
from repro_torch.core import query as TQuery
from repro_torch.core.query import NeighborSet

jax.config.update("jax_platform_name", "cpu")

KINDS = ["uniform", "snapped", "planar"]


def _cloud(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32: uniform, snapped to a coarse grid (many ties), or planar."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if kind == "snapped":
        x = (np.round(x * 4) / 4).astype(np.float32)
    elif kind == "planar":
        x[:, 2] = 0.5
    return x


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype) if want.dtype != got.dtype else want)


def _pair(x: np.ndarray):
    return jnp.asarray(x), torch.from_numpy(x)


# -- FPS ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_fps_bitwise(kind, metric):
    jp, tp = _pair(_cloud(kind, 200, seed=1))
    _eq(TF.fps(tp, 40, metric=metric), JF.fps(jp, 40, metric=metric))
    _eq(TF.fps(tp, 17, metric=metric, start_idx=123),
        JF.fps(jp, 17, metric=metric, start_idx=123))


@pytest.mark.parametrize("kind", KINDS)
def test_fps_valid_mask(kind):
    """Masked slots are never sampled; the start is the first valid slot."""
    jp, tp = _pair(_cloud(kind, 96, seed=2))
    valid = np.random.default_rng(3).uniform(size=96) < 0.6
    valid[:5] = False  # slot 0 is padding
    jv, tv = _pair(valid)
    got = TF.fps(tp, 24, valid=tv)
    _eq(got, JF.fps(jp, 24, valid=jv))
    assert valid[got.numpy()].all()
    _eq(TF.fps(tp, 8, valid=tv, start_idx=2), JF.fps(jp, 8, valid=jv, start_idx=2))


def test_fps_few_and_no_valid_slots():
    """Fewer valid points than k re-picks the first valid maximum; none samples slot 0."""
    jp, tp = _pair(_cloud("uniform", 32, seed=4))
    few = np.zeros(32, bool)
    few[[7, 19, 30]] = True
    none = np.zeros(32, bool)
    for valid in (few, none):
        jv, tv = _pair(valid)
        _eq(TF.fps(tp, 10, metric="l2", valid=tv), JF.fps(jp, 10, metric="l2", valid=jv))
    assert (TF.fps(tp, 4, valid=torch.from_numpy(none)).numpy() == 0).all()
    with pytest.raises(ValueError):
        TF.fps(tp, 33)


def test_fused_fps_step_bitwise():
    jp, tp = _pair(_cloud("snapped", 64, seed=5))
    valid = np.arange(64) % 5 != 0
    dmin = np.random.default_rng(6).uniform(0, 2, 64).astype(np.float32)
    want_d, want_i = JF.fused_fps_step(jp, jnp.asarray(dmin), jnp.int32(9), "l1",
                                       jnp.asarray(valid))
    got_d, got_i = TF.fused_fps_step(tp, torch.from_numpy(dmin), torch.tensor(9), "l1",
                                     torch.from_numpy(valid))
    _eq(got_d, want_d)
    assert int(got_i) == int(want_i)


@pytest.mark.parametrize("kind", KINDS)
def test_fps_batched_with_and_without_mask(kind):
    pts = np.stack([_cloud(kind, 80, seed=s) for s in range(6)]).reshape(2, 3, 80, 3)
    valid = np.random.default_rng(7).uniform(size=(2, 3, 80)) < 0.7
    jp, tp = _pair(pts)
    _eq(TF.fps_batched(tp, 12, metric="l2"), JF.fps_batched(jp, 12, metric="l2"))
    _eq(TF.fps_batched(tp, 12, valid=torch.from_numpy(valid)),
        JF.fps_batched(jp, 12, valid=jnp.asarray(valid)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [16, 8])
def test_quantize_coords_and_quantized_l1_fps(kind, bits):
    jp, tp = _pair(_cloud(kind, 150, seed=8) * 3 + 1)
    jq, js, jo = JF.quantize_coords(jp, bits)
    tq, ts, to = TF.quantize_coords(tp, bits)
    _eq(tq, jq)
    _eq(ts, js)
    _eq(to, jo)
    _eq(TF.fps_l1_quantized(tq, 30), JF.fps_l1_quantized(jq, 30))
    _eq(TF.fps_l1_quantized(tq, 9, start_idx=77), JF.fps_l1_quantized(jq, 9, start_idx=77))


@pytest.mark.parametrize("kind", KINDS)
def test_sampling_quality_metrics(kind):
    """Covering radius and min separation of L1 against L2 samples, one cloud and batched."""
    clouds = np.stack([_cloud(kind, 120, seed=s) for s in (9, 10)])
    for metric in ("l1", "l2"):
        rows = []
        for c in clouds:
            jp, tp = _pair(c)
            idx = np.asarray(JF.fps(jp, 20, metric=metric))
            ti = torch.from_numpy(idx.copy())
            cov = TF.coverage_radius(tp, ti)
            sep = TF.min_pairwise_separation(tp, ti)
            _eq(cov, JF.coverage_radius(jp, jnp.asarray(idx)))
            _eq(sep, JF.min_pairwise_separation(jp, jnp.asarray(idx)))
            rows.append((idx, cov, sep))
        idx_b = torch.from_numpy(np.stack([r[0] for r in rows]))
        _eq(TF.coverage_radius(torch.from_numpy(clouds), idx_b), np.stack([r[1] for r in rows]))
        _eq(TF.min_pairwise_separation(torch.from_numpy(clouds), idx_b),
            np.stack([r[2] for r in rows]))


# -- partitions ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,multiple", [(100, 8), (64, 8), (1, 4)])
def test_pad_points(n, multiple):
    jp, tp = _pair(_cloud("uniform", n, seed=11))
    want_p, want_v = JPart.pad_points(jp, multiple)
    got_p, got_v = TPart.pad_points(tp, multiple)
    _eq(got_p, want_p)
    _eq(got_v, want_v)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [10, 4])
def test_morton_codes_and_partition(kind, bits):
    c = _cloud(kind, 128, seed=12)
    jp, tp = _pair(c)
    # the reference's uint32 codes, compared as int64
    _eq(TPart.morton_codes(tp, bits), np.asarray(JPart.morton_codes(jp, bits)).astype(np.int64))
    for depth in (0, 2, 3):
        want = JPart.morton_partition(jp, depth)
        got = TPart.morton_partition(tp, depth)
        _eq(got.tiles, want.tiles)
        _eq(got.valid, want.valid)
    batched = TPart.morton_partition(torch.from_numpy(np.stack([c, c[::-1].copy()])), 2)
    _eq(batched.tiles[0], JPart.morton_partition(jp, 2).tiles)
    with pytest.raises(ValueError):
        TPart.morton_partition(tp[:100], 3)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("grid,capacity", [(2, 32), (2, 8), (3, 16), (2, 1), (4, 64)])
def test_grid_partition(kind, grid, capacity):
    """Overflow dropped (small capacities), empty cells (grid 4 over 96 points), capacity 1."""
    c = _cloud(kind, 96, seed=13)
    jp, tp = _pair(c)
    want = JPart.grid_partition(jp, grid, capacity)
    got = TPart.grid_partition(tp, grid, capacity)
    _eq(got.tiles, want.tiles)
    _eq(got.valid, want.valid)
    assert (got.n_tiles, got.tile_size) == (grid**3, capacity)
    _eq(got.utilization(), want.utilization())
    _eq(TPart.partition_coords(tp, got), JPart.partition_coords(jp, want))
    # batched: each cloud on its own
    c2 = _cloud(kind, 96, seed=14) * 0.3
    both = TPart.grid_partition(torch.from_numpy(np.stack([c, c2])), grid, capacity)
    want2 = JPart.grid_partition(jnp.asarray(c2), grid, capacity)
    _eq(both.tiles[1], want2.tiles)
    _eq(both.valid[1], want2.valid)
    _eq(both.tiles[0], want.tiles)


def test_grid_partition_has_empty_cells_and_overflow():
    c = _cloud("uniform", 96, seed=13)
    part = TPart.grid_partition(torch.from_numpy(c), 4, 64)
    assert (~part.valid.any(dim=-1)).any()  # some of the 64 cells hold no point
    small = TPart.grid_partition(torch.from_numpy(c), 2, 8)
    assert int(small.valid.sum()) < 96  # overflow past capacity 8 dropped


# -- queries ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.05, 4), (2.0, 16), (0.5, 40)])
def test_ball_query_bitwise(kind, radius, nsample):
    pts = _cloud(kind, 96, seed=15)
    cents = pts[::6].copy()
    want = JQuery.ball_query(jnp.asarray(pts), jnp.asarray(cents), radius, nsample)
    got = TQuery.ball_query(torch.from_numpy(pts), torch.from_numpy(cents), radius, nsample)
    _eq(got.idx, want.idx)
    _eq(got.mask, want.mask)


def test_ball_query_valid_and_batched():
    pts = np.stack([_cloud("snapped", 64, seed=s) for s in (16, 17)])
    cents = pts[:, ::8].copy()
    valid = np.random.default_rng(18).uniform(size=(2, 64)) < 0.5
    got = TQuery.ball_query(torch.from_numpy(pts), torch.from_numpy(cents), 0.45, 8,
                            valid=torch.from_numpy(valid))
    for i in range(2):
        want = JQuery.ball_query(jnp.asarray(pts[i]), jnp.asarray(cents[i]), 0.45, 8,
                                 valid=jnp.asarray(valid[i]))
        _eq(got.idx[i], want.idx)
        _eq(got.mask[i], want.mask)


def test_knn_valid_mask():
    q = _cloud("snapped", 40, seed=19)
    r = _cloud("snapped", 50, seed=20)
    valid = np.arange(50) % 4 != 1
    want_i, want_d = JQuery.knn(jnp.asarray(q), jnp.asarray(r), 3, valid=jnp.asarray(valid))
    got_i, got_d = TQuery.knn(torch.from_numpy(q), torch.from_numpy(r), 3,
                              valid=torch.from_numpy(valid))
    _eq(got_i, want_i)
    _eq(got_d, want_d)


def test_neighbor_overlap_is_fig12a_recall():
    """Lattice against ball neighbours of L2-FPS centroids, as fig12a counts them."""
    pts = _cloud("snapped", 128, seed=27)
    jp, tp = _pair(pts)
    c = np.asarray(JF.fps(jp, 16, metric="l2"))
    cents = pts[c]
    ball = JQuery.ball_query(jp, jnp.asarray(cents), 0.3, nsample=128)
    lat = JQuery.lattice_query(jp, jnp.asarray(cents), 0.3, nsample=128)
    bm, lm, bi, li = (np.asarray(x) for x in (ball.mask, lat.mask, ball.idx, lat.idx))
    tot = cap = 0
    for m in range(16):
        bset, lset = set(bi[m][bm[m]].tolist()), set(li[m][lm[m]].tolist())
        tot += len(bset)
        cap += len(bset & lset)
    t_ball = TQuery.ball_query(tp, torch.from_numpy(cents), 0.3, 128)
    t_lat = TQuery.lattice_query(tp, torch.from_numpy(cents), 0.3, 128)
    found, total = TQuery.neighbor_overlap(t_ball, t_lat, 128)
    assert (int(found), int(total)) == (cap, tot) and 0 < cap <= tot
    # batched over clouds: one count a cloud
    two = TQuery.neighbor_overlap(
        NeighborSet(torch.stack([t_ball.idx, t_lat.idx]), torch.stack([t_ball.mask, t_lat.mask])),
        NeighborSet(torch.stack([t_lat.idx, t_lat.idx]), torch.stack([t_lat.mask, t_lat.mask])),
        128)
    assert two[0].tolist() == [cap, int(t_lat.mask.sum())] and two[1][0] == tot


# -- quant helpers ---------------------------------------------------------------------------


def test_dequantize_and_combine_planes():
    x = (np.random.default_rng(21).normal(size=(40, 9)) * 3).astype(np.float32)
    for bits in (16, 8):
        jt = JQ.quantize_symmetric(jnp.asarray(x), bits)
        tt = TQ.quantize_symmetric(torch.from_numpy(x), bits)
        _eq(TQ.dequantize(tt), JQ.dequantize(jt))
        n = bits // 4
        tp = TQ.split_planes(tt.q, n)
        _eq(TQ.combine_planes(tp), JQ.combine_planes(JQ.split_planes(jt.q, n)))
        _eq(TQ.combine_planes(tp), tt.q)


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_linear_bitwise(bits):
    rng = np.random.default_rng(22)
    x = rng.normal(size=(3, 11, 19)).astype(np.float32)
    w = (rng.normal(size=(19, 7)) / 4).astype(np.float32)
    want = JQ.quantized_linear(jnp.asarray(x), jnp.asarray(w), bits=bits)
    got = TQ.quantized_linear(torch.from_numpy(x), torch.from_numpy(w), bits=bits)
    _eq(got, want)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_ptq_error(bits):
    x = (np.random.default_rng(23).normal(size=(64, 48)) * 2).astype(np.float32)
    want = float(JQ.ptq_error(jnp.asarray(x), bits))
    got = TQ.ptq_error(torch.from_numpy(x), bits)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


# -- grouping -----------------------------------------------------------------------------


def test_group_relative_coords_and_aggregations():
    rng = np.random.default_rng(24)
    xyz = _cloud("uniform", 50, seed=25)
    feats = rng.normal(size=(50, 6)).astype(np.float32)
    cents = xyz[::5].copy()
    j_nb = JQuery.ball_query(jnp.asarray(xyz), jnp.asarray(cents), 0.6, 8)
    t_nb = NeighborSet(torch.from_numpy(np.asarray(j_nb.idx).copy()),
                       torch.from_numpy(np.asarray(j_nb.mask).copy()))
    _eq(TGroup.group_relative_coords(torch.from_numpy(xyz), torch.from_numpy(cents), t_nb),
        JGroup.group_relative_coords(jnp.asarray(xyz), jnp.asarray(cents), j_nb))
    w = (rng.normal(size=(6, 4)) / 3).astype(np.float32)
    j_mlp = lambda x: jnp.maximum(x * 2.0 - 0.5, 0.0) @ jnp.asarray(w)  # noqa: E731
    t_mlp = lambda x: torch.clamp(x * 2.0 - 0.5, min=0.0) @ torch.from_numpy(w)  # noqa: E731
    for jf, tf in ((JGroup.aggregate_standard, TGroup.aggregate_standard),
                   (JGroup.aggregate_delayed, TGroup.aggregate_delayed)):
        want = jf(jnp.asarray(feats), j_nb, j_mlp)
        got = tf(torch.from_numpy(feats), t_nb, t_mlp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# -- the per-cloud pipelines ----------------------------------------------------------------


def _assert_results_equal(got, want):
    _eq(got.centroid_idx, want.centroid_idx)
    _eq(got.centroid_xyz, want.centroid_xyz)
    _eq(got.neighbors.idx, want.neighbors.idx)
    _eq(got.neighbors.mask, want.neighbors.mask)
    _eq(got.centroid_valid, want.centroid_valid)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pipeline,kw", [
    ("baseline1", {}),
    ("baseline2", {}),
    ("baseline2", {"grid": 2, "capacity": 12}),
    ("baseline2", {"grid": 3, "capacity": 40}),
    ("pc2im", {"depth": 2}),
    ("pc2im", {"depth": 3, "axis_mode": "cycle"}),
])
def test_per_cloud_pipelines_bitwise(kind, pipeline, kw):
    jp, tp = _pair(_cloud(kind, 128, seed=26))
    m = 54 if kw.get("grid") == 3 else 32
    want = JPre.PIPELINES[pipeline](jp, m, 0.3, 16, **kw)
    got = TPre.PIPELINES[pipeline](tp, m, 0.3, 16, **kw)
    _assert_results_equal(got, want)
    if kind == "planar" and kw.get("grid") == 3:
        assert not got.centroid_valid.all()  # empty cells sample padded slot 0


def test_baseline2_default_capacity_and_divisibility():
    assert TPre.grid_capacity(256, 2) == 64
    assert TPre.grid_capacity(100, 2) == 32
    assert TPre.grid_capacity(4096, 2, 7) == 7
    with pytest.raises(ValueError):
        TPre.preprocess_baseline2(torch.from_numpy(_cloud("uniform", 64)), 20, 0.3, 8)
