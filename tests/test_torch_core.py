"""Port parity, core modules: policy, MSP partition, distances, lattice query,
kNN with the 3-NN interpolation, SC quantization and the pc2im PreprocessEngine, each held against the JAX
package on the same numpy inputs.  Every output here is an integer, a
selection or an exactly-rounded float, so every comparison is bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.core import engine as JE
from repro.core import fps as JF
from repro.core import grouping as JGroup
from repro.core import partition as JPart
from repro.core import policy as JPol
from repro.core import quant as JQ
from repro.core import query as JQuery
from repro.kernels.sc_matmul.ref import sc_matmul_ref as j_sc_matmul_ref
from repro_torch.core import engine as TE
from repro_torch.core import fps as TF
from repro_torch.core import grouping as TGroup
from repro_torch.core import partition as TPart
from repro_torch.core import policy as TPol
from repro_torch.core import quant as TQ
from repro_torch.core import query as TQuery

jax.config.update("jax_platform_name", "cpu")


def _clouds(kind: str, b: int, n: int, seed: int = 0) -> np.ndarray:
    """(b, n, 3) float32: uniform, snapped to a coarse grid (many ties), or planar."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    if kind == "snapped":
        x = (np.round(x * 4) / 4).astype(np.float32)
    elif kind == "planar":
        x[..., 2] = 0.5
    return x


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- policy -------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    {}, {"quant": "sc_w16a16"}, {"quant": "sc_w8a8", "backend": "xla"},
    {"backend": "pallas", "pipeline": "pipelined"}, {"sharding": "batch"},
])
def test_policy_matches_reference(kwargs):
    jp, tp = JPol.ExecutionPolicy(**kwargs), TPol.ExecutionPolicy(**kwargs)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.quant_bits == jp.quant_bits
    assert tp.resolved_backend("xla") == jp.resolved_backend("xla")
    cfg = type("Cfg", (), {"quant": "sc_w16a16", "preproc_backend": "xla"})()
    assert dataclasses.asdict(TPol.resolve_policy(cfg, tp)) == dataclasses.asdict(
        JPol.resolve_policy(cfg, jp)
    )
    assert dataclasses.asdict(TPol.resolve_policy(cfg, None)) == dataclasses.asdict(
        JPol.resolve_policy(cfg, None)
    )


@pytest.mark.parametrize("kwargs", [
    {"quant": "int4"}, {"backend": "cuda"}, {"pipeline": "async"},
    {"sharding": "batch", "pipeline": "pipelined"},
])
def test_policy_rejects_like_reference(kwargs):
    with pytest.raises(ValueError):
        JPol.ExecutionPolicy(**kwargs)
    with pytest.raises(ValueError):
        TPol.ExecutionPolicy(**kwargs)


# -- MSP partition ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "snapped", "planar"])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("axis_mode", ["widest", "cycle"])
def test_median_partition_bitwise(kind, depth, axis_mode):
    pts = _clouds(kind, 3, 128, seed=depth)
    want = jax.vmap(
        lambda p: JPart.median_partition(p, depth, axis_mode=axis_mode).tiles
    )(jnp.asarray(pts))
    got = TPart.median_partition(torch.from_numpy(pts), depth, axis_mode=axis_mode)
    _eq(got.tiles, want)
    assert bool(got.valid.all())
    # one cloud at a time gives the same tiles
    single = TPart.median_partition(torch.from_numpy(pts[1]), depth, axis_mode=axis_mode)
    _eq(single.tiles, want[1])


def test_median_partition_rejects_indivisible():
    with pytest.raises(ValueError):
        TPart.median_partition(torch.zeros(100, 3), 3)


# -- distances and the lattice query ------------------------------------------


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_pairwise_distance_bitwise(metric):
    a, b = _clouds("uniform", 1, 40, seed=1)[0], _clouds("snapped", 1, 33, seed=2)[0]
    want = JF.pairwise_distance(jnp.asarray(a), jnp.asarray(b), metric)
    _eq(TF.pairwise_distance(torch.from_numpy(a), torch.from_numpy(b), metric), want)


@pytest.mark.parametrize("kind", ["uniform", "snapped"])
@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.05, 4), (2.0, 16), (0.6, 40)])
def test_lattice_query_bitwise(kind, radius, nsample):
    pts = _clouds(kind, 1, 96, seed=3)[0]
    cents = pts[::6]
    want = JQuery.lattice_query(jnp.asarray(pts), jnp.asarray(cents), radius, nsample)
    got = TQuery.lattice_query(torch.from_numpy(pts), torch.from_numpy(cents), radius, nsample)
    _eq(got.idx, want.idx)
    _eq(got.mask, want.mask)


def test_lattice_query_batched_and_valid_mask():
    pts = _clouds("snapped", 2, 64, seed=4)
    cents = pts[:, ::8]
    valid = np.arange(64) % 3 != 0
    for i in range(2):
        want = JQuery.lattice_query(
            jnp.asarray(pts[i]), jnp.asarray(cents[i]), 0.4, 8, valid=jnp.asarray(valid)
        )
        got = TQuery.lattice_query(
            torch.from_numpy(pts), torch.from_numpy(cents), 0.4, 8,
            valid=torch.from_numpy(valid),
        )
        _eq(got.idx[i], want.idx)
        _eq(got.mask[i], want.mask)


# -- kNN and 3-NN interpolation (seg FP stages) -----------------------------------


@pytest.mark.parametrize("kind", ["uniform", "snapped"])
@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_knn_bitwise(kind, metric, k):
    """Indices and distances; the snapped cloud is full of equal distances."""
    qs, ref = _clouds(kind, 1, 50, seed=7)[0], _clouds(kind, 1, 37, seed=8)[0]
    wi, wd = JQuery.knn(jnp.asarray(qs), jnp.asarray(ref), k, metric=metric)
    gi, gd = TQuery.knn(torch.from_numpy(qs), torch.from_numpy(ref), k, metric=metric)
    assert gi.dtype == torch.int32
    _eq(gi, wi)
    _eq(gd, wd)


def test_knn_batched_and_interpolation_bitwise():
    """Batched knn equals the reference per cloud; the 3-NN weights (self-matches
    included, distance 0) and the interpolation agree to the bit, since both
    packages add the same terms in the same order."""
    fine = _clouds("snapped", 2, 48, seed=9)
    coarse = fine[:, ::4].copy()  # every coarse point is also a fine point
    feats = np.random.default_rng(10).normal(size=(2, 12, 5)).astype(np.float32)
    idx, dist = TQuery.knn(torch.from_numpy(fine), torch.from_numpy(coarse), 3)
    w = TQuery.three_nn_interpolate_weights(dist)
    out = TGroup.interpolate_features(torch.from_numpy(feats), idx, w)
    assert out.shape == (2, 48, 5)
    for b in range(2):
        wi, wd = JQuery.knn(jnp.asarray(fine[b]), jnp.asarray(coarse[b]), 3)
        _eq(idx[b], wi)
        _eq(dist[b], wd)
        ww = JQuery.three_nn_interpolate_weights(wd)
        _eq(w[b], ww)
        _eq(out[b], JGroup.interpolate_features(jnp.asarray(feats[b]), wi, ww))


# -- SC quantization ------------------------------------------------------------


@pytest.mark.parametrize("bits", [16, 8])
def test_quantize_symmetric_bitwise(bits):
    x = np.random.default_rng(bits).normal(size=(64, 33)).astype(np.float32)
    x[3, 4] = 0.5 * np.abs(x).max()  # halfway values exercise round-half-even
    want = JQ.quantize_symmetric(jnp.asarray(x), bits)
    got = TQ.quantize_symmetric(torch.from_numpy(x), bits)
    _eq(got.q, want.q)
    _eq(got.scale, want.scale)
    assert got.q.dtype == torch.int32


@pytest.mark.parametrize("n_planes", [1, 2, 4])
def test_split_planes_bitwise(n_planes):
    lim = 1 << (4 * n_planes - 1)
    q = np.random.default_rng(0).integers(-lim, lim, size=(50,), dtype=np.int32)
    q[:2] = [-lim, lim - 1]
    _eq(TQ.split_planes(torch.from_numpy(q), n_planes), JQ.split_planes(jnp.asarray(q), n_planes))


def _int_operands(m, k, n, bits, seed=0):
    rng = np.random.default_rng(seed)
    lim = 1 << (bits - 1)
    x = rng.integers(-lim, lim, size=(m, k), dtype=np.int32)
    w = rng.integers(-lim, lim, size=(k, n), dtype=np.int32)
    x[0, :] = -lim  # extremes of the range
    w[:, 0] = lim - 1
    return x, w


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("m,k,n", [(8, 3, 16), (17, 64, 9), (32, 259, 40)])
def test_sc_matmul_bitwise(bits, m, k, n):
    x, w = _int_operands(m, k, n, bits, seed=m + k)
    n_planes = bits // 4
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    # exact combine equals numpy's int64 product
    exact = TQ.sc_matmul(tx, tw, n_planes=n_planes, combine="int64")
    np.testing.assert_array_equal(exact.numpy(), x.astype(np.int64) @ w.astype(np.int64))
    # per-diagonal int32 sums equal numpy's, plane pair by plane pair
    xp = np.asarray(JQ.split_planes(jnp.asarray(x), n_planes)).astype(np.int64)
    wp = np.asarray(JQ.split_planes(jnp.asarray(w), n_planes)).astype(np.int64)
    for d, dot in enumerate(TQ.diagonal_dots(tx, tw, n_planes)):
        want = sum(xp[i] @ wp[d - i] for i in range(n_planes) if 0 <= d - i < n_planes)
        np.testing.assert_array_equal(dot.numpy(), want.astype(np.int32))
    # float32 combine equals the reference's, bit for bit
    want_f32 = j_sc_matmul_ref(jnp.asarray(x), jnp.asarray(w), n_planes=n_planes)
    _eq(TQ.sc_matmul(tx, tw, n_planes=n_planes, combine="f32"), want_f32)


# -- the pc2im PreprocessEngine -----------------------------------------------


@pytest.mark.parametrize("n,depth", [(64, 2), (300, 3), (1024, 2), (7, 0)])
def test_clamp_depth_matches_reference(n, depth):
    for m in (4, 16, 64, 256):
        assert TE.clamp_depth(n, m, depth) == JE.clamp_depth(n, m, depth)


def _engine_pair(n_centroids, radius, nsample, depth):
    kw = dict(pipeline="pc2im", n_centroids=n_centroids, radius=radius,
              nsample=nsample, depth=depth)
    return JE.PreprocessEngine(JE.EngineConfig(backend="xla", **kw)), TE.PreprocessEngine(
        TE.EngineConfig(**kw)
    )


def _assert_results_equal(got, want):
    _eq(got.centroid_idx, want.centroid_idx)
    _eq(got.centroid_xyz, want.centroid_xyz)
    _eq(got.neighbors.idx, want.neighbors.idx)
    _eq(got.neighbors.mask, want.neighbors.mask)
    _eq(got.centroid_valid, want.centroid_valid)


@pytest.mark.parametrize("kind", ["uniform", "snapped", "planar"])
def test_engine_cls_smoke_stages_bitwise(kind):
    """Both SA stages of the cls smoke config: 256 -> 64 (r=0.3) -> 16 (r=0.6)."""
    pts = _clouds(kind, 3, 256, seed=5)
    xyz_j, xyz_t = jnp.asarray(pts), torch.from_numpy(pts)
    for m, radius, depth in [(64, 0.3, 2), (16, 0.6, 2)]:
        depth = JE.clamp_depth(xyz_t.shape[1], m, depth)
        jeng, teng = _engine_pair(m, radius, 16, depth)
        want, got = jeng(xyz_j), teng(xyz_t)
        _assert_results_equal(got, want)
        xyz_j, xyz_t = want.centroid_xyz, got.centroid_xyz


def test_engine_single_cloud_and_validation():
    pts = _clouds("snapped", 1, 128, seed=6)[0]
    jeng, teng = _engine_pair(32, 0.4, 8, 2)
    _assert_results_equal(teng(torch.from_numpy(pts)), jeng(jnp.asarray(pts)))
    with pytest.raises(ValueError):
        teng(torch.zeros(2, 130, 3))  # N not divisible by the 4 tiles
    with pytest.raises(ValueError):
        teng(torch.zeros(2, 128, 2))
    with pytest.raises(ValueError):
        TE.PreprocessEngine(TE.EngineConfig(n_centroids=30, depth=2))
    with pytest.raises(ValueError):
        TE.PreprocessEngine(TE.EngineConfig(query="cube"))
    with pytest.raises(ValueError):
        TE.PreprocessEngine(TE.EngineConfig(pipeline="grid"))
    assert TE.get_engine(TE.EngineConfig()) is TE.get_engine(TE.EngineConfig())
