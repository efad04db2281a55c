"""Port parity, kernels: each plain PyTorch version against the JAX package's
Pallas kernel (interpret mode, tiny shapes) and XLA reference, bitwise
(indices and masks; knn3's distances are bitwise against the XLA oracle,
whose coordinate sum the port repeats, and within rtol 1e-6 of the Pallas
kernel's own reduction); the
registry's device dispatch and launch counters; the CUDA wrappers' refusals
on the CPU; and the nvcc build's command line.  The CUDA kernels themselves
run only on a card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels.fps.ops import fps_tiles as j_fps_tiles
from repro.kernels.knn3.ops import knn3 as j_knn3
from repro.kernels.knn3.ref import knn3_ref as j_knn3_ref
from repro.kernels.lattice.ops import lattice_query_fused as j_lattice_fused
from repro.kernels.lattice.ops import lattice_query_tiles as j_lattice_tiles
from repro.kernels.sc_matmul.ops import sc_matmul_op as j_sc_matmul_op
from repro.kernels.sc_matmul.ops import sc_quantized_linear as j_sc_linear
from repro_torch.kernels import build, registry
from repro_torch.kernels.fps.kernel import fps_tiles_cuda
from repro_torch.kernels.fps.ops import fps_tiles
from repro_torch.kernels.fps.ref import fps_tiles_plain
from repro_torch.kernels.knn3.kernel import MAX_K, knn3_cuda
from repro_torch.kernels.knn3.ops import knn3
from repro_torch.kernels.lattice.kernel import lattice_query_cuda, lattice_tiles_cuda
from repro_torch.kernels.lattice.ops import lattice_query_fused, lattice_query_tiles
from repro_torch.kernels.sc_matmul.kernel import sc_matmul_cuda
from repro_torch.kernels.sc_matmul.ops import sc_matmul_op, sc_quantized_linear

jax.config.update("jax_platform_name", "cpu")


def _tiles(t, p, seed=0, snapped=False):
    x = np.random.default_rng(seed).uniform(-1, 1, (t, p, 3)).astype(np.float32)
    return (np.round(x * 4) / 4).astype(np.float32) if snapped else x


# -- FPS ------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("snapped", [False, True])
def test_fps_plain_matches_pallas_interpret(metric, snapped):
    pts = _tiles(2, 128, seed=1, snapped=snapped)
    want = j_fps_tiles(jnp.asarray(pts), 8, metric=metric, backend="pallas", interpret=True)
    got = fps_tiles(torch.from_numpy(pts), 8, metric=metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("t,p,k", [(32, 64, 16), (3, 200, 12), (1, 5, 5)])
def test_fps_plain_matches_reference_any_tile_size(metric, t, p, k):
    """The port takes any P (no lane padding): same indices as the XLA reference."""
    pts = _tiles(t, p, seed=p, snapped=True)
    want = j_fps_tiles(jnp.asarray(pts), k, metric=metric, backend="xla")
    np.testing.assert_array_equal(fps_tiles_plain(torch.from_numpy(pts), k, metric=metric).numpy(),
                                  np.asarray(want))


# -- lattice ----------------------------------------------------------------------


@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.05, 4), (1.5, 16)])
def test_lattice_plain_matches_pallas_interpret(radius, nsample):
    pts = _tiles(2, 128, seed=2, snapped=True)
    cents = pts[:, ::16].copy()
    want = j_lattice_tiles(jnp.asarray(pts), jnp.asarray(cents), radius, nsample,
                           backend="pallas", interpret=True)
    got = lattice_query_tiles(torch.from_numpy(pts), torch.from_numpy(cents), radius, nsample)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_lattice_plain_matches_reference_any_tile_size():
    pts = _tiles(5, 70, seed=3)
    cents = pts[:, :9].copy()
    want = j_lattice_tiles(jnp.asarray(pts), jnp.asarray(cents), 0.2, 32, backend="xla")
    got = lattice_query_tiles(torch.from_numpy(pts), torch.from_numpy(cents), 0.2, 32)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("m,p,ns", [(4, 128, 8), (16, 256, 16), (128, 512, 32)])
@pytest.mark.parametrize("snapped", [False, True])
def test_lattice_fused_plain_matches_pallas_interpret(m, p, ns, snapped):
    """The flat query at tests/test_kernels.py's shapes, and on a tie-heavy cloud."""
    pts = _tiles(1, p, seed=p, snapped=snapped)[0]
    cents = pts[:m].copy()
    want = j_lattice_fused(jnp.asarray(pts), jnp.asarray(cents), 0.4, ns,
                           backend="pallas", interpret=True)
    got = lattice_query_fused(torch.from_numpy(pts), torch.from_numpy(cents), 0.4, ns)
    assert got.idx.shape == (m, ns) and got.idx.dtype == torch.int32
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_lattice_fused_plain_non_multiple_shapes():
    pts = _tiles(1, 200, seed=11)[0]
    cents = pts[:50].copy()
    for backend in ("pallas", "xla"):
        want = j_lattice_fused(jnp.asarray(pts), jnp.asarray(cents), 0.5, 8,
                               backend=backend, interpret=True)
        got = lattice_query_fused(torch.from_numpy(pts), torch.from_numpy(cents), 0.5, 8)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    with pytest.raises(ValueError):
        lattice_query_fused(torch.from_numpy(pts)[None], torch.from_numpy(cents), 0.5, 8)


# -- knn3 -------------------------------------------------------------------------


def _knn_inputs(q, p, seed, snapped):
    qs = _tiles(1, q, seed=seed, snapped=snapped)[0]
    pts = _tiles(1, p, seed=seed + 1, snapped=snapped)[0]
    return qs, pts


def _check_knn(qs, pts, k, metric):
    """Port vs the XLA oracle (indices and distances bitwise) and vs the Pallas
    kernel in interpret mode (indices bitwise; distances at rtol 1e-6, since
    that kernel reduces the squared terms with its own jnp.sum over a
    (bq, 3, P) block and lands one ulp off on some L2 distances)."""
    gi, gd = knn3(torch.from_numpy(qs)[None], torch.from_numpy(pts)[None], k=k, metric=metric)
    gi, gd = gi[0], gd[0]
    assert gi.shape == (qs.shape[0], k) and gi.dtype == torch.int32 and gd.dtype == torch.float32
    ri, rd = j_knn3_ref(jnp.asarray(qs), jnp.asarray(pts).T, k=k, metric=metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    pi, pd = j_knn3(jnp.asarray(qs), jnp.asarray(pts), k=k, metric=metric,
                    backend="pallas", interpret=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(pd), rtol=1e-6, atol=0)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("q,p", [(8, 128), (64, 256), (100, 200)])
@pytest.mark.parametrize("snapped", [False, True])
def test_knn3_plain_matches_pallas_interpret(metric, q, p, snapped):
    _check_knn(*_knn_inputs(q, p, seed=q, snapped=snapped), 3, metric)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_knn3_plain_k_sweep(metric, k):
    _check_knn(*_knn_inputs(16, 128, seed=1, snapped=True), k, metric)


@pytest.mark.parametrize("q,p", [(1, 100), (5, 130), (7, 128), (13, 257), (261, 129), (300, 640)])
def test_knn3_plain_odd_shapes(q, p):
    _check_knn(*_knn_inputs(q, p, seed=q, snapped=False), 3, "l2")


def test_knn3_batched_equals_per_cloud():
    """(B, Q, 3) x (B, P, 3) is B independent clouds, indices local to each."""
    qs = torch.from_numpy(_tiles(3, 40, seed=5, snapped=True))
    pts = torch.from_numpy(_tiles(3, 70, seed=6, snapped=True))
    idx, dist = knn3(qs, pts)
    assert idx.shape == (3, 40, 3)
    for b in range(3):
        ib, db = knn3(qs[b:b + 1], pts[b:b + 1])
        assert torch.equal(idx[b], ib[0]) and torch.equal(dist[b], db[0])
    with pytest.raises(ValueError):
        knn3(qs[0], pts[0])  # one cloud is (1, Q, 3)


def test_knn3_rejects_bad_shapes():
    q, p = torch.zeros(2, 5, 3), torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):
        knn3(q, p, k=5)  # more neighbours than points
    with pytest.raises(ValueError):
        knn3(q, p, k=0)
    with pytest.raises(ValueError):
        knn3(q, torch.zeros(3, 4, 3))
    with pytest.raises(ValueError):
        knn3(q, p, metric="cos")



# -- the split-and-merge rules of csrc/knn3.cu and csrc/lattice.cu, modelled ------------
#
# Small torch models of what the kernels do with the work a plan splits, held
# against the plain versions, so that a fault in the design shows before the
# card runs it.  The package does not use them.


def _knn_split_merge(queries, points, k, metric, group, unroll=4, chunk=1024):
    """csrc/knn3.cu's rules for one cloud: lane g of a group takes points g, g + G, ...
    of each staged chunk (padded with inf points to whole steps of G * unroll), in
    index order, and inserts (d, j) behind every equal entry when d is below its own
    k-th; the lanes' lists then merge by (distance, index)."""
    from repro_torch.core.fps import pairwise_distance

    d = pairwise_distance(queries, points, metric)  # (Q, P), the kernel's sums
    q, p = d.shape
    bd = torch.full((q, group, k), float("inf"))
    bi = torch.zeros((q, group, k), dtype=torch.int64)
    lanes = torch.arange(group)
    step_pts = group * unroll
    for base in range(0, p, chunk):
        n = min(chunk, p - base)
        for i0 in range(0, -(-n // step_pts) * step_pts, step_pts):
            for u in range(unroll):
                i = i0 + u * group + lanes
                j = base + i
                dd = torch.where(i < n, d[:, j.clamp(max=p - 1)], float("inf"))  # (Q, G)
                ins = dd < bd[..., -1]
                # behind every equal entry: a stable sort with the old entries first
                cat_d = torch.cat([bd, dd[..., None]], dim=-1)
                cat_i = torch.cat([bi, j.expand(q, group)[..., None]], dim=-1)
                order = torch.sort(cat_d, dim=-1, stable=True).indices[..., :k]
                bd = torch.where(ins[..., None], torch.take_along_dim(cat_d, order, -1), bd)
                bi = torch.where(ins[..., None], torch.take_along_dim(cat_i, order, -1), bi)
    flat_d, flat_i = bd.reshape(q, -1), bi.reshape(q, -1)
    by_idx = torch.sort(flat_i, dim=-1, stable=True).indices  # (distance, index) order
    flat_d, flat_i = (torch.take_along_dim(a, by_idx, -1) for a in (flat_d, flat_i))
    order = torch.sort(flat_d, dim=-1, stable=True).indices[..., :k]
    return (torch.take_along_dim(flat_i, order, -1).to(torch.int32),
            torch.take_along_dim(flat_d, order, -1))


def _knn_model_cases():
    rng = np.random.default_rng(7)
    snapped = np.round(rng.uniform(-1, 1, (90, 3)) * 2) / 2  # 125 grid values: many ties
    huge = rng.uniform(-1, 1, (40, 3))
    huge[::3] = 1e20  # squared distances overflow to inf
    return {
        "snapped": (snapped[:50], snapped[10:], 5),
        "identical": (np.full((6, 3), 0.5), np.full((37, 3), 0.5), 3),
        "p_below_g_times_k": (rng.uniform(-1, 1, (9, 3)), rng.uniform(-1, 1, (13, 3)), 3),
        "overflow": (np.concatenate([huge[:9], [[1e20] * 3, [-1e20] * 3]]), huge, 8),
        "all_inf": (np.full((3, 3), 2e38), np.full((9, 3), -2e38), 4),  # inf in either metric
        "ragged_chunks": (rng.uniform(-1, 1, (20, 3)), rng.uniform(-1, 1, (203, 3)), 3),
    }


@pytest.mark.parametrize("case", sorted(_knn_model_cases()))
@pytest.mark.parametrize("group,chunk", [(1, 1024), (4, 64), (8, 1024), (16, 96), (32, 1024)])
@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_knn3_split_merge_model_matches_plain(case, group, chunk, metric):
    """Lanes scanning interleaved shares, merged by (distance, index): the first k of
    a stable sort among finite distances, and (inf, 0) wherever no finite distance
    is left."""
    qs, pts, k = (torch.from_numpy(np.asarray(a, np.float32)) if isinstance(a, np.ndarray) else a
                  for a in _knn_model_cases()[case])
    got = _knn_split_merge(qs, pts, k, metric, group, chunk=chunk)
    want = knn3(qs[None], pts[None], k=k, metric=metric)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    if case == "all_inf":
        assert torch.isinf(got[1]).all() and not got[0].any()


def _lattice_segments(points, cents, l_range, nsample, warps, chunk, unroll=4):
    """csrc/lattice.cu's rules for one tile: per staged chunk, padded with NaN points
    to whole steps of 32 * unroll points in each of W equal segments, warp w keeps
    the hits of segment w up to the row's remaining slots; an exclusive scan of the
    warps' counts gives each its first slot, and the first warp with a hit (none
    before it) holds the row's first hit."""
    from repro_torch.core.fps import pairwise_distance

    lim = torch.tensor(np.float32(l_range))
    m, p = cents.shape[0], points.shape[0]
    out = torch.zeros((m, nsample), dtype=torch.int32)
    count = [0] * m
    first = [0] * m
    for cb in range(0, p, chunk):
        cn = min(chunk, p - cb)
        step = 32 * unroll * warps
        cpad = -(-cn // step) * step
        seg = cpad // warps
        staged = torch.cat([points[cb:cb + cn], torch.full((cpad - cn, 3), float("nan"))])
        hit = pairwise_distance(cents, staged, "l1") <= lim  # (M, cpad), padding included
        for r in range(m):
            cap = nsample - count[r]
            kept = []
            for s in range(warps):  # an all-padding segment keeps nothing
                kept.append((torch.nonzero(hit[r, s * seg:(s + 1) * seg])[:, 0] + cb + s * seg)
                            [:cap])
            before = 0
            for s in range(warps):
                if count[r] == 0 and before == 0 and len(kept[s]):
                    first[r] = int(kept[s][0])
                for i, j in enumerate(kept[s]):
                    if count[r] + before + i < nsample:
                        out[r, count[r] + before + i] = int(j)
                before += len(kept[s])
            count[r] += min(before, cap)
    msk = torch.arange(nsample)[None, :] < torch.tensor(count)[:, None]
    fill = torch.tensor(first, dtype=torch.int32)[:, None]
    return torch.where(msk, out, fill), msk


def _lattice_model_cases():
    rng = np.random.default_rng(8)
    snapped = (np.round(rng.uniform(-1, 1, (300, 3)) * 4) / 4).astype(np.float32)
    return {
        "snapped": (snapped, snapped[::7], 0.3, 8),
        "identical": (np.full((100, 3), 0.25, np.float32), np.full((5, 3), 0.25, np.float32),
                      0.1, 16),
        "no_hit": (rng.uniform(-1, 1, (130, 3)).astype(np.float32),
                   np.full((4, 3), 9.0, np.float32), 0.5, 8),
        "all_in_range": (rng.uniform(-1, 1, (260, 3)).astype(np.float32),
                         rng.uniform(-1, 1, (6, 3)).astype(np.float32), 10.0, 32),
        "sparse_long_rows": (rng.uniform(-1, 1, (700, 3)).astype(np.float32),
                             rng.uniform(-1, 1, (12, 3)).astype(np.float32), 0.15, 16),
        # a range of inf, and a finite one that rounds to inf in float32: every
        # point hits, fewer points than slots, so only the padding is left
        "unbounded": (rng.uniform(-1, 1, (40, 3)).astype(np.float32),
                      rng.uniform(-1, 1, (5, 3)).astype(np.float32), float("inf"), 64),
        "rounds_to_inf": (rng.uniform(-1, 1, (90, 3)).astype(np.float32),
                          rng.uniform(-1, 1, (3, 3)).astype(np.float32), 1e39, 128),
    }


@pytest.mark.parametrize("case", sorted(_lattice_model_cases()))
@pytest.mark.parametrize("warps,chunk,unroll", [(1, 4096, 4), (2, 64, 2), (4, 4096, 4),
                                                (8, 100, 2), (8, 4096, 4), (8, 50, 4)])
def test_lattice_segment_scan_model_matches_plain(case, warps, chunk, unroll):
    """Segment counts, their exclusive scan and the first non-empty segment's first
    hit give the plain version's slots, fill and mask, chunk after chunk."""
    pts, cents, radius, ns = _lattice_model_cases()[case]
    pts, cents = torch.from_numpy(pts), torch.from_numpy(cents)
    l_range = float(radius * 1.6)
    got = _lattice_segments(pts, cents, l_range, ns, warps, chunk, unroll)
    want = lattice_query_fused(pts, cents, radius, ns)
    assert torch.equal(got[0], want.idx) and torch.equal(got[1], want.mask)
    if case == "no_hit":
        assert not got[1].any() and not got[0].any()
    if case == "all_in_range":
        assert got[1].all()
    if case in ("unbounded", "rounds_to_inf"):
        assert int(got[1].sum()) == pts.shape[0] * cents.shape[0]


# -- the plans of the knn3 and lattice kernels ----------------------------------------


def _fp_shapes():
    """(B, Q, P) of the seg forward's two 3-NN calls over 8 clouds: FP0, FP1."""
    from repro_torch.configs.pointnet2_seg import CONFIG as SEG

    sizes = [SEG.n_points] + [sa.n_centroids for sa in SEG.sa]
    return [(8, sizes[i - 1], sizes[i]) for i in range(len(sizes) - 1, 0, -1)]


def _tile_shapes():
    """(T, K, P, nsample) of each SA stage's lattice query over 8 clouds, cls then seg."""
    from repro_torch.configs.pointnet2_cls import CONFIG as CLS
    from repro_torch.configs.pointnet2_seg import CONFIG as SEG
    from repro_torch.core.engine import clamp_depth

    shapes = []
    for cfg in (CLS, SEG):
        n = cfg.n_points
        for sa in cfg.sa:
            depth = clamp_depth(n, sa.n_centroids, cfg.msp_depth)
            shapes.append((8 << depth, sa.n_centroids >> depth, n >> depth, sa.nsample))
            n = sa.n_centroids
    return shapes


def test_knn3_plan_at_main_path_shapes():
    """FP0 and FP1 get the plans the kernel was tuned for; every lane of a group has
    points of its own; the block is whole groups."""
    from repro_torch.kernels.knn3.kernel import UNROLL, knn3_plan

    assert _fp_shapes() == [(8, 1024, 256), (8, 4096, 1024)]
    assert [tuple(knn3_plan(b, q, p, 3)) for b, q, p in _fp_shapes()] == [(8, 256), (4, 256)]
    for b in (1, 3, 8):
        for q in (1, 5, 129, 1024, 4097):
            for p in (1, 2, 7, 31, 64, 100, 1025, 5000):
                for k in (1, 3, 8):
                    if k > p:
                        continue
                    plan = knn3_plan(b, q, p, k)
                    assert plan.group & (plan.group - 1) == 0 and plan.group <= 32
                    assert plan.group == 1 or plan.group * UNROLL <= p
                    assert plan.threads % 32 == 0
                    assert plan.threads % plan.group == 0 and plan.queries_per_block() >= 1


@pytest.mark.parametrize("args", [(0, 8, 8, 3), (8, -1, 8, 3), (8, 8, 2.0, 1), (8, 8, 8, True),
                                  (8, 8, 8, 9), (8, 8, 2, 3), (None, 8, 8, 3)])
def test_knn3_plan_refuses_bad_sizes(args):
    from repro_torch.kernels.knn3.kernel import knn3_plan

    with pytest.raises(ValueError):
        knn3_plan(*args)


def test_lattice_plan_at_main_path_shapes():
    """The four tile shapes and the two flat sets get the plans the kernel was tuned
    for; a split row's segments are whole steps; a plan never needs more shared
    memory than a block has."""
    from repro_torch.kernels.lattice.kernel import MAX_SMEM, lattice_plan

    assert _tile_shapes() == [(32, 64, 256, 32), (32, 16, 64, 32), (64, 128, 512, 32),
                              (64, 32, 128, 32)]
    got = [tuple(lattice_plan(*s)) for s in _tile_shapes()]
    assert got == [(1, 8, 4, 256, 256), (1, 8, 2, 64, 256), (1, 16, 4, 512, 256),
                   (1, 8, 4, 128, 256)]
    flat = [tuple(lattice_plan(1, m, p, ns)) for p, m, ns in ((2048, 64, 16), (4096, 1024, 32))]
    assert flat == [(8, 1, 4, 2048, 256), (2, 4, 4, 4096, 256)]
    for t in (1, 7, 64):
        for k in (1, 3, 64, 1024):
            for p in (1, 33, 200, 2048, 4097, 20000):
                for ns in (1, 16, 300):
                    plan = lattice_plan(t, k, p, ns)
                    w, warps = plan.warps_per_row, plan.threads // 32
                    assert plan.threads % 32 == 0 and warps % w == 0 and w & (w - 1) == 0
                    assert 1 <= plan.rows_per_block <= k and plan.unroll in (2, 4)
                    assert 1 <= plan.chunk <= p and plan.smem_bytes(ns) <= MAX_SMEM
                    assert w == 1 or ns <= 256
                    # W equal segments of whole steps cover the padded chunk; one that
                    # holds only padding is walked as empty (the model test above)
                    padded = plan.padded_chunk()
                    assert padded % w == 0 and (padded // w) % (32 * plan.unroll) == 0
                    assert 0 <= padded - plan.chunk < 32 * plan.unroll * w


@pytest.mark.parametrize("args", [(0, 8, 8, 3), (1, -1, 8, 3), (1, 8, 2.0, 1), (1, 8, 8, True),
                                  (1, 8, 8, 0), (None, 8, 8, 3)])
def test_lattice_plan_refuses_bad_sizes(args):
    from repro_torch.kernels.lattice.kernel import lattice_plan

    with pytest.raises(ValueError):
        lattice_plan(*args)


# -- SC matmul ---------------------------------------------------------------------


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (16, 131, 32), (8, 384, 16)])
def test_sc_matmul_plain_matches_pallas_interpret(bits, m, k, n):
    """K a multiple of 32, a ragged K (the kernel zero-pads it) and a deep one."""
    lim = 1 << (bits - 1)
    rng = np.random.default_rng(bits + k)
    x = rng.integers(-lim, lim, (m, k), dtype=np.int32)
    w = rng.integers(-lim, lim, (k, n), dtype=np.int32)
    want = j_sc_matmul_op(jnp.asarray(x), jnp.asarray(w), bits=bits, backend="pallas",
                          interpret=True)
    got = sc_matmul_op(torch.from_numpy(x), torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("lead", [(40,), (2, 33)])
def test_sc_quantized_linear_bitwise(bits, lead):
    rng = np.random.default_rng(len(lead))
    x = rng.normal(size=lead + (19,)).astype(np.float32)
    w = (rng.normal(size=(19, 24)) * 0.1).astype(np.float32)
    want = j_sc_linear(jnp.asarray(x), jnp.asarray(w), bits=bits, backend="xla")
    got = sc_quantized_linear(torch.from_numpy(x), torch.from_numpy(w), bits=bits)
    assert got.shape == lead + (24,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _linear_shapes(cfg):
    """(M, K, N) of every dense layer of one forward over 8 clouds (cls or seg)."""
    from repro_torch.models.pointnet2 import PointNet2Params

    model = PointNet2Params(cfg, device="cpu")
    batch = 8
    counts = {"sa": [cfg.n_points] + [sa.n_centroids for sa in cfg.sa]}
    shapes = []
    for i, mlp in enumerate(model.sa):
        shapes += [(batch * counts["sa"][i], *layer.lin.w.shape) for layer in mlp.layers]
    if cfg.task == "cls":
        rows = [batch * cfg.sa[-1].n_centroids] * len(model.global_mlp.layers) + [batch] * len(
            model.head.layers)
        mlps = [*model.global_mlp.layers, *model.head.layers]
    else:
        fine = counts["sa"][-2::-1]
        mlps, rows = [], []
        for level, mlp in zip(fine, model.fp):
            mlps += list(mlp.layers)
            rows += [batch * level] * len(mlp.layers)
        mlps += list(model.head.layers)
        rows += [batch * cfg.n_points] * len(model.head.layers)
    shapes += [(r, *layer.lin.w.shape) for r, layer in zip(rows, mlps)]
    return shapes


def test_sc_matmul_k_splits_at_main_path_shapes():
    """Only the cls head (M = 8) splits K; every share is non-empty."""
    from repro_torch.configs.pointnet2_cls import CONFIG as CLS
    from repro_torch.configs.pointnet2_seg import CONFIG as SEG
    from repro_torch.kernels.sc_matmul.kernel import TILE_K, k_splits

    cls, seg = _linear_shapes(CLS), _linear_shapes(SEG)
    assert len(cls) == len(seg) == 12
    assert cls[-3:] == [(8, 1024, 512), (8, 512, 256), (8, 256, 8)]
    assert seg[8] == (32768, 259, 128)
    got = {shape: k_splits(shape[0], shape[2], shape[1]) for shape in cls + seg}
    assert {s: v for s, v in got.items() if v > 1} == {
        (8, 1024, 512): 16, (8, 512, 256): 8, (8, 256, 8): 4}
    for m in (1, 8, 64, 65):
        for n in (1, 8, 64, 1000):
            for k in (1, 31, 33, 64, 259, 1024, 4096):
                s = k_splits(m, n, k)
                steps = -(-k // TILE_K)
                per = -(-steps // s)
                assert 1 <= s <= steps and (s - 1) * per < steps
                assert s == 1 or m <= 64


@pytest.mark.parametrize("bad", [0, -3, 2.0, True, None])
def test_sc_matmul_k_splits_refuses_bad_sizes(bad):
    from repro_torch.kernels.sc_matmul.kernel import k_splits

    with pytest.raises(ValueError):
        k_splits(bad, 8, 8)
    with pytest.raises(ValueError):
        k_splits(8, 8, bad)


def test_sc_matmul_op_rejects_bad_bits():
    with pytest.raises(ValueError):
        sc_matmul_op(torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32),
                     bits=10)


# -- registry: dispatch and launch counters -------------------------------------------


def test_registry_dispatch_by_device():
    x = torch.zeros(2, 4, 3)
    assert set(registry.names()) >= {"fps_tiles", "lattice_tiles", "lattice_query",
                                     "sc_matmul", "knn3"}
    for backend in (None, "auto", "pallas", "xla"):
        assert registry.dispatch("fps_tiles", x, backend) is fps_tiles_plain
    with pytest.raises(ValueError):
        registry.dispatch("fps_tiles", x, "cuda")
    with pytest.raises(KeyError):
        registry.dispatch("nope", x)
    with pytest.raises(ValueError):
        registry.dispatch("fps_tiles", torch.zeros(2, device="meta"))


def test_plain_versions_do_not_count_launches():
    registry.reset_launches()
    fps_tiles(torch.from_numpy(_tiles(2, 16)), 4)
    lattice_query_tiles(torch.from_numpy(_tiles(2, 16)), torch.zeros(2, 3, 3), 0.5, 4)
    lattice_query_fused(torch.from_numpy(_tiles(1, 16)[0]), torch.zeros(3, 3), 0.5, 4)
    knn3(torch.zeros(2, 5, 3), torch.from_numpy(_tiles(2, 16)))
    assert registry.launches() == {name: 0 for name in registry.names()}
    registry.count_launch("fps_tiles")
    assert registry.launches()["fps_tiles"] == 1
    registry.reset_launches()
    assert registry.launches()["fps_tiles"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper checks every tensor before any pointer (or nvcc) is touched."""
    pts = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fps_tiles_cuda(pts, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lattice_tiles_cuda(pts, torch.zeros(2, 2, 3), nsample=4, l_range=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        lattice_query_cuda(pts[0], torch.zeros(2, 3), nsample=4, l_range=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        knn3_cuda(pts, pts)
    with pytest.raises(ValueError, match="CUDA"):
        sc_matmul_cuda(torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32))
    assert MAX_K >= 5  # the reference's tests sweep k = 1, 3, 5
    with pytest.raises(ValueError):
        registry.require_cuda_tensor(torch.zeros(3), "x", torch.float32, 1)


# -- build ------------------------------------------------------------------------------


_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__3e5b17f8_12_sc_matmul_cu_aa688ff616sc_matmul_kernelILi4ELb1ELb0EEEvPKiS2_PfPiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__3e5b17f8_12_sc_matmul_cu_aa688ff616sc_matmul_kernelILi4ELb1ELb0EEEvPKiS2_PfPiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__ef20d935_6_fps_cu_aa688ff615fps_warp_kernelILi16ELb1EEEvPKfPiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__ef20d935_6_fps_cu_aa688ff615fps_warp_kernelILi16ELb1EEEvPKfPiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 94 registers, 384 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_smem_and_spills():
    report = build.ptxas_report(_PTXAS_LOG)
    assert report == [
        {"kernel": "sc_matmul_kernel<4,1,0>", "registers": 168, "smem_bytes": 16,
         "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "fps_warp_kernel<16,1>", "registers": 94, "smem_bytes": 0,
         "stack_bytes": 8, "spill_stores": 4, "spill_loads": 4},
    ]
    assert build.ptxas_report("") == []
    assert build.kernel_label("_ZN12_GLOBAL__N_16kernelILi2EEEvv") == "kernel<2>"
    assert build.kernel_label("_Z6kernelPf") == "_Z6kernelPf"


def test_build_targets_hopper_without_fma_contraction(tmp_path):
    cmd = build.compile_command("fps", "nvcc", tmp_path / "fps.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert str(build.SRC_DIR / "fps.cu") in cmd and "-shared" in cmd
    sources = sorted(p.stem for p in build.SRC_DIR.glob("*.cu"))
    assert sources == sorted(build.SOURCES)
    # one library per source and compiler, named by a hash of what built it
    a, b = build.library_path("fps", "nvcc"), build.library_path("fps", "/other/nvcc")
    assert a != b and a.parent == build.BUILD_DIR and a.suffix == ".so"
    assert build.library_path("fps", "nvcc") == a
