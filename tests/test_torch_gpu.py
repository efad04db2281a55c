"""Each CUDA kernel against its plain PyTorch version on the card, bitwise, at
the main-path shapes of full-width forwards over 8 clouds (pointnet2-cls:
1024 points; pointnet2-seg: 4096 points, whose FP stages run the knn3
kernel), at the flat lattice query's shapes, and at ragged sizes that
exercise the kernels' other paths.  Then the captured CUDA graphs
(core/graphs.py): every entry point's replay bitwise equal to
graphs.eager() at smoke and full width, on side streams, on the pipelined
pair and in the serving runtime, where nothing is captured after warmup.
Then training (launch/train.py): the whole step replayed as one graph,
bitwise equal to eager steps under deterministic kernels, a checkpoint
round trip from the card, and the entry point.  Last, multi-device: the
sharded artifacts against single-device eager infer on two cards and on
two shards of one card, the collectives' ordering across streams, a
sharded ServingRuntime beside a thread replaying graphs, pipeline_forward,
and a kernel on another card leaving the current device alone (the
two-card tests skip below two cards).  And the paper's comparison paths:
the FPS kernel under L2 at baseline-1's global shapes, the SC kernel at
standard aggregation's row counts, and the five comparison corners'
replays against eager with their launches.  Then the LMs: the SC kernel
at every dense, moe, ssm, hybrid, encdec and vlm LM shape, the smoke
configs served and trained on the card against plain and against the CPU
(`-k lm`, `-k lm_families`, `-k lm_encdec_vlm`), tied MoE routing alike on
both, and a whisper decode step (its cross-attention over the cached
encoder K/V) replayed as a CUDA graph.  Last, the LM's device layout (`-k
lm_mesh`): the dense smoke configs under the host mesh's activation hints,
bitwise equal to the same calls without them, and the op counter's counts
on the card equal to those on meta tensors.  Last, the graph layer's spans
(`-k traced_replays`): at each closed-loop benchmark cell's shape, the
program's launch spans hold the profiler's cudaGraphLaunch records on one
clock, and the forward graph's stage marks time the card's work.

Needs an NVIDIA card (Hopper, sm_90a) and nvcc; every test skips where
torch.cuda.is_available() is false.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports neither jax nor the JAX package: the card's host has neither.
"""

import contextlib
import dataclasses
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.pointnet2_cls import CONFIG
from repro_torch.configs.pointnet2_seg import CONFIG as SEG_CONFIG
from repro_torch.core import graphs
from repro_torch.core import grouping as G
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.engine import clamp_depth, result_leaves, result_to_host
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.kernels import registry
from repro_torch.kernels.fps.kernel import fps_tiles_cuda
from repro_torch.kernels.fps.ops import fps_tiles
from repro_torch.kernels.fps.ref import fps_tiles_plain
from repro_torch.kernels.group_pool.kernel import group_maxpool_cuda
from repro_torch.kernels.group_pool.ops import group_maxpool
from repro_torch.kernels.group_pool.ref import group_maxpool_plain
from repro_torch.kernels.knn3.kernel import Knn3Plan, knn3_cuda, knn3_plan
from repro_torch.kernels.knn3.ops import knn3
from repro_torch.kernels.knn3.ref import knn3_plain
from repro_torch.kernels.lattice.kernel import (
    LatticePlan,
    lattice_plan,
    lattice_query_cuda,
    lattice_tiles_cuda,
)
from repro_torch.kernels.lattice.ref import lattice_query_plain, lattice_tiles_plain
from repro_torch.kernels.sc_matmul.kernel import sc_matmul_cuda
from repro_torch.kernels.sc_matmul.ref import sc_matmul_plain

pytestmark = pytest.mark.gpu
BATCH = 8


def _preprocess_shapes(cfg=CONFIG):
    """(T, P, k, radius, nsample) of each SA stage's kernels for BATCH clouds."""
    shapes, n = [], cfg.n_points
    for sa in cfg.sa:
        depth = clamp_depth(n, sa.n_centroids, cfg.msp_depth)
        shapes.append((BATCH << depth, n >> depth, sa.n_centroids >> depth, sa.radius, sa.nsample))
        n = sa.n_centroids
    return shapes


def _seg_fp_shapes():
    """(B, Q, P) of each FP stage's 3-NN for BATCH seg clouds, coarsest first."""
    sizes = [SEG_CONFIG.n_points] + [sa.n_centroids for sa in SEG_CONFIG.sa]
    return [(BATCH, sizes[i - 1], sizes[i]) for i in range(len(sizes) - 1, 0, -1)]


def _seg_n_linears():
    """Dense layers of one seg forward: SA MLPs, FP MLPs (two layers each), head."""
    return (sum(len(sa.mlp) for sa in SEG_CONFIG.sa) + 2 * len(SEG_CONFIG.sa)
            + len(SEG_CONFIG.head) + 1)


def _seg_linear_shapes():
    """(M, K, N) of every dense layer of one seg forward over BATCH clouds: the SA
    MLPs, the FP MLPs (coarsest first; [interpolated, skip] -> cout -> cout), the head."""
    shapes, sizes, c_in = [], [SEG_CONFIG.n_points], 3
    for sa in SEG_CONFIG.sa:
        for c in sa.mlp:
            shapes.append((BATCH * sizes[-1], c_in, c))
            c_in = c
        sizes.append(sa.n_centroids)
        c_in += 3
    skips = [3] + [sa.mlp[-1] for sa in SEG_CONFIG.sa[:-1]]
    c_coarse = SEG_CONFIG.sa[-1].mlp[-1]
    for i, skip in enumerate(reversed(skips)):
        cout = SEG_CONFIG.fp_mlp[min(i, len(SEG_CONFIG.fp_mlp) - 1)]
        m = BATCH * sizes[len(skips) - 1 - i]
        shapes += [(m, c_coarse + skip, cout), (m, cout, cout)]
        c_coarse = cout
    for c in (*SEG_CONFIG.head, SEG_CONFIG.n_classes):
        shapes.append((BATCH * SEG_CONFIG.n_points, c_coarse, c))
        c_coarse = c
    return shapes


def _linear_shapes():
    """(M, K, N) of every dense layer of one cls forward over BATCH clouds."""
    shapes, n, c_in = [], CONFIG.n_points, 3
    for sa in CONFIG.sa:
        for c in sa.mlp:
            shapes.append((BATCH * n, c_in, c))
            c_in = c
        n, c_in = sa.n_centroids, c_in + 3
    for c in CONFIG.global_mlp:
        shapes.append((BATCH * n, c_in, c))
        c_in = c
    for c in (*CONFIG.head, CONFIG.n_classes):
        shapes.append((BATCH, c_in, c))
        c_in = c
    return shapes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tiles(t, p, device, seed=0, snapped=False):
    x = np.random.default_rng(seed).uniform(-1, 1, (t, p, 3)).astype(np.float32)
    if snapped:
        x = np.round(x * 8) / 8
    return torch.from_numpy(x.astype(np.float32)).to(device)


def test_main_path_shapes():
    assert [s[:3] for s in _preprocess_shapes()] == [(32, 256, 64), (32, 64, 16)]
    assert [s[:3] for s in _preprocess_shapes(SEG_CONFIG)] == [(64, 512, 128), (64, 128, 32)]
    assert len(_linear_shapes()) == 12 and _linear_shapes()[0] == (8192, 3, 64)
    assert _seg_fp_shapes() == [(8, 1024, 256), (8, 4096, 1024)]
    assert _seg_n_linears() == len(_seg_linear_shapes()) == 12
    assert _seg_linear_shapes()[6:9] == [(8192, 384, 256), (8192, 256, 256), (32768, 259, 128)]
    assert _seg_linear_shapes()[-1] == (32768, 128, 8)


@pytest.mark.parametrize("model", ["cls", "seg"])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("snapped", [False, True])
def test_fps_kernel_matches_plain(cuda, model, stage, metric, snapped):
    t, p, k, _, _ = _preprocess_shapes(CONFIG if model == "cls" else SEG_CONFIG)[stage]
    pts = _tiles(t, p, cuda, seed=stage, snapped=snapped)
    got = fps_tiles_cuda(pts, k, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_tiles_plain(pts, k, metric=metric))


@pytest.mark.parametrize("t,p,k", [(3, 1000, 40), (3, 3000, 24), (3, 8192, 8), (3, 5, 5),
                                   (3, 1024, 64), (3, 1025, 64), (600, 64, 16), (300, 33, 8)])
def test_fps_kernel_ragged_tile_sizes(cuda, t, p, k):
    """Either side of the one-warp-a-tile limit (P = 1024), and the tile counts
    at which a block takes 4 and 2 tiles."""
    pts = _tiles(t, p, cuda, seed=p, snapped=True)
    for metric in ("l1", "l2"):
        got = fps_tiles_cuda(pts, k, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(got, fps_tiles_plain(pts, k, metric=metric))


@pytest.mark.parametrize("p", [100, 1024, 2000])
def test_fps_kernel_identical_points(cuda, p):
    """Every dmin ties at 0 after the first step: the first index wins each time."""
    pts = torch.full((2, p, 3), 0.25, device=cuda)
    got = fps_tiles_cuda(pts, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_tiles_plain(pts, 9))
    assert not got.any()


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("snapped", [False, True])
def test_lattice_kernel_matches_plain(cuda, stage, snapped):
    t, p, k, radius, ns = _preprocess_shapes()[stage]
    pts = _tiles(t, p, cuda, seed=10 + stage, snapped=snapped)
    local = fps_tiles_plain(pts, k).long()
    cents = torch.take_along_dim(pts, local[..., None], dim=1).contiguous()
    l_range = float(radius * 1.6)
    got = lattice_tiles_cuda(pts, cents, nsample=ns, l_range=l_range)
    torch.cuda.synchronize()
    want = lattice_tiles_plain(pts, cents, nsample=ns, l_range=l_range)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("p,k,ns,l_range", [(70, 9, 32, 0.2), (300, 40, 4, 3.0), (33, 5, 64, 0.0),
                                             (33, 5, 64, float("inf")), (100, 7, 128, 1e39)])
def test_lattice_kernel_ragged_sizes(cuda, p, k, ns, l_range):
    """Ragged tiles under every plan (a tile's rows split across blocks and warps),
    and a range of inf (or one that rounds to inf) with fewer points than slots, so
    that the staged padding is all that is left to hit."""
    pts = _tiles(4, p, cuda, seed=p, snapped=True)
    cents = pts[:, :k].contiguous()
    want = lattice_tiles_plain(pts, cents, nsample=ns, l_range=l_range)
    for plan in _lattice_plans(4, k, p, ns):
        got = lattice_tiles_cuda(pts, cents, nsample=ns, l_range=l_range, _plan=plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), plan


def _int_operands(m, k, n, bits, device, seed=0):
    rng = np.random.default_rng(seed)
    lim = 1 << (bits - 1)
    x = rng.integers(-lim, lim, (m, k), dtype=np.int32)
    w = rng.integers(-lim, lim, (k, n), dtype=np.int32)
    x[0], w[:, 0] = -lim, lim - 1
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


@pytest.mark.parametrize("shape", _linear_shapes() + _seg_linear_shapes())
@pytest.mark.parametrize("bits", [16, 8])
def test_sc_matmul_kernel_matches_plain(cuda, shape, bits):
    """Every dense layer of the cls and the seg forward; the cls head splits K."""
    m, k, n = shape
    x, w = _int_operands(m, k, n, bits, cuda, seed=m + k + n)
    got = sc_matmul_cuda(x, w, n_planes=bits // 4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=bits // 4))


@pytest.mark.parametrize("m,k,n,bits", [(33, 70, 17, 16), (1, 1, 1, 16), (100, 37, 65, 12),
                                        (7, 9, 3, 4), (1, 1024, 64, 16), (8, 1024, 1024, 16),
                                        (16, 1024, 1024, 8), (8, 1000, 517, 12), (16, 131, 259, 16),
                                        (65, 1024, 33, 16), (1100, 70, 17, 16), (2000, 1024, 64, 8)])
def test_sc_matmul_kernel_ragged_sizes(cuda, m, k, n, bits):
    """Ragged edges, unaligned x rows and 4-byte w copies (K or N not a multiple of
    4), split K (M <= 64), w kept resident with a ragged N (M >= 1024) and a K too
    deep for it."""
    x, w = _int_operands(m, k, n, bits, cuda, seed=m)
    got = sc_matmul_cuda(x, w, n_planes=bits // 4)
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=bits // 4))
    exact = (x.cpu().to(torch.int64) @ w.cpu().to(torch.int64)).double()
    # the f32 combine rounds: relative to the largest entry, as the reference's tests
    assert (got.cpu().double() - exact).abs().max() <= 1e-6 * exact.abs().max()


@pytest.mark.parametrize("value", [-(1 << 15), (1 << 15) - 1])
@pytest.mark.parametrize("m", [8, 100])
def test_sc_matmul_kernel_extreme_operands(cuda, value, m):
    """Every operand at one end of the 16-bit range, K = 1024: the largest
    diagonal sums (with and without split K) stay exact."""
    x = torch.full((m, 1024), value, dtype=torch.int32, device=cuda)
    w = torch.full((1024, 96), value, dtype=torch.int32, device=cuda)
    got = sc_matmul_cuda(x, w, n_planes=4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=4))
    exact = float(value * value * 1024)
    assert (got.double() - exact).abs().max() <= 1e-6 * exact


def test_forward_launches_each_kernel(cuda):
    params = get_accelerator(CONFIG, device=cuda).init(torch.Generator().manual_seed(0))
    pts = np.random.default_rng(0).uniform(-1, 1, (BATCH, CONFIG.n_points, 3)).astype(np.float32)
    for quant, n_sc in (("none", 0), ("sc_w16a16", len(_linear_shapes()))):
        accel = get_accelerator(CONFIG, ExecutionPolicy(quant=quant), device=cuda)
        registry.reset_launches()
        logits = accel.infer(params, pts)
        torch.cuda.synchronize()
        assert logits.shape == (BATCH, CONFIG.n_classes) and bool(torch.isfinite(logits).all())
        assert registry.launches() == {"fps_tiles": 2, "lattice_tiles": 2, "sc_matmul": n_sc,
                                       "knn3": 0, "lattice_query": 0, "group_maxpool": 2}


def test_seg_forward_launches_each_kernel(cuda):
    """A full-width seg forward: 2 FPS, 2 lattice, 2 knn3 and 2 group_maxpool
    launches (+12 SC)."""
    params = get_accelerator(SEG_CONFIG, device=cuda).init(torch.Generator().manual_seed(0))
    pts = np.random.default_rng(1).uniform(-1, 1, (BATCH, SEG_CONFIG.n_points, 3))
    for quant, n_sc in (("none", 0), ("sc_w16a16", _seg_n_linears())):
        accel = get_accelerator(SEG_CONFIG, ExecutionPolicy(quant=quant), device=cuda)
        registry.reset_launches()
        logits = accel.infer(params, pts.astype(np.float32))
        torch.cuda.synchronize()
        assert logits.shape == (BATCH, SEG_CONFIG.n_points, SEG_CONFIG.n_classes)
        assert bool(torch.isfinite(logits).all())
        assert registry.launches() == {"fps_tiles": 2, "lattice_tiles": 2, "sc_matmul": n_sc,
                                       "knn3": 2, "lattice_query": 0, "group_maxpool": 2}


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("snapped", [False, True])
def test_knn3_kernel_matches_plain(cuda, stage, metric, snapped):
    """Seg FP shapes; the queries contain every reference point (self-matches)."""
    b, q, p = _seg_fp_shapes()[stage]
    queries = _tiles(b, q, cuda, seed=20 + stage, snapped=snapped)
    points = queries[:, ::q // p].contiguous()
    got = knn3_cuda(queries, points, k=3, metric=metric)
    torch.cuda.synchronize()
    want = knn3_plain(queries, points, k=3, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _knn3_plans(b, q, p, k):
    """knn3_plan's choice and groups of 1 to 32 lanes in blocks of 64 to 256
    threads (csrc/knn3.cu refuses none of them)."""
    plans = [knn3_plan(b, q, p, k)]
    for g, n in ((1, 128), (2, 128), (4, 128), (8, 128), (16, 128), (32, 128), (8, 64),
                 (16, 256), (32, 256)):
        plans.append(Knn3Plan(g, n))
    return plans


@pytest.mark.parametrize("b,q,p,k", [(1, 1, 5, 5), (3, 130, 1, 1), (2, 1000, 2500, 8),
                                     (1, 129, 1024, 3), (5, 77, 1025, 2), (2, 300, 7, 3),
                                     (3, 257, 61, 8), (4, 513, 1000, 1), (1, 64, 4100, 8),
                                     (8, 1024, 256, 3)])
def test_knn3_kernel_ragged_sizes(cuda, b, q, p, k):
    """P not a multiple of any lane group, step or staged chunk (and P < G * k),
    k = 1 to 8, L1 and L2, under every plan: on snapped clouds (ties), on identical
    points, and with coordinates whose distances overflow to inf (1e20 squares to
    inf; 2e38 overflows either metric), where slots nothing finite fills read
    (inf, 0)."""
    queries = _tiles(b, q, cuda, seed=q, snapped=True)
    points = _tiles(b, p, cuda, seed=p + 1, snapped=True)
    far_q, far_p = queries.clone(), points.clone()
    far_q[:, ::5] = -1e20
    far_p[:, ::3] = 1e20
    huge_q, huge_p = queries.clone(), points.clone()
    huge_q[:, 1::2] = 2e38
    huge_p[:, ::2] = -2e38
    inputs = {"snapped": (queries, points), "far": (far_q, far_p), "huge": (huge_q, huge_p),
              "identical": (torch.full_like(queries, 0.25), torch.full_like(points, 0.25))}
    for kind, (qs, ps) in inputs.items():
        for metric in ("l1", "l2"):
            want = knn3_plain(qs, ps, k=k, metric=metric)
            for plan in _knn3_plans(b, q, p, k):
                got = knn3_cuda(qs, ps, k=k, metric=metric, _plan=plan)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                    kind, metric, plan)
    assert torch.isinf(knn3_plain(*inputs["huge"], k=k)[1]).any()


def _lattice_plans(t, k, p, ns):
    """lattice_plan's choice and plans of 1 to 8 warps a row, several rows a warp
    group, both unrolls, and small chunks that make several staged passes."""
    plans = [lattice_plan(t, k, p, ns)]
    for w in (1, 2, 4, 8):
        for rows in (1, 3, 8, 16):
            for unroll in (2, 4):
                plans.append(LatticePlan(w, min(k, rows), unroll, min(p, 4096), 256))
    plans += [LatticePlan(4, 2, 4, 100, 256), LatticePlan(1, 5, 2, 33, 128),
              LatticePlan(2, 4, 4, 1000, 64), LatticePlan(8, 40, 2, 70, 256)]
    return plans


@pytest.mark.parametrize("p,m,radius,ns", [(2048, 64, 0.3, 16), (4096, 1024, 0.2, 32),
                                           (200, 50, 0.5, 8), (4096, 1, 0.2, 32),
                                           (4100, 64, 0.1, 16), (10000, 3, 0.05, 40),
                                           (333, 1024, 0.3, 300)])
@pytest.mark.parametrize("snapped", [False, True])
def test_lattice_query_kernel_matches_plain(cuda, p, m, radius, ns, snapped):
    """The flat query at the example's shapes, at a seg-sized set, ragged ones (P
    not a multiple of a chunk of 32, a step, a segment or the staged chunk), M = 1,
    64 and 1024, under every plan: on the cloud's own neighbourhoods, on dense ones
    (every point in range), on empty ones (no hit: slots and fill read 0) and with a
    range of inf (with P < nsample, only the staged padding is left to hit)."""
    pts = _tiles(1, p, cuda, seed=p, snapped=snapped)[0]
    cents = pts[(torch.arange(m, device=cuda) * max(1, p // m)) % p].contiguous()
    l_range = float(radius * 1.6)
    hoods = {"cloud": (cents, l_range), "dense": (cents, 10.0), "empty": (cents + 5.0, l_range),
             "unbounded": (cents, float("inf"))}
    for hood, (c, lr) in hoods.items():
        want = lattice_query_plain(pts, c, nsample=ns, l_range=lr)
        for plan in _lattice_plans(1, m, p, ns):
            if plan.smem_bytes(ns) > 232448:
                continue
            got = lattice_query_cuda(pts, c, nsample=ns, l_range=lr, _plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (hood, plan)
        if hood == "empty":
            assert not want[1].any() and not want[0].any()
        if hood == "dense":
            assert want[1].all()
        if hood == "unbounded":
            assert int(want[1].sum()) == m * min(p, ns)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pts = _tiles(2, 64, cuda)
    with pytest.raises(ValueError, match="xla"):
        fps_tiles(pts, 4, backend="xla")
    with pytest.raises(ValueError, match="contiguous"):
        fps_tiles_cuda(pts.transpose(1, 2).contiguous().transpose(1, 2), 4)
    with pytest.raises(ValueError):
        fps_tiles_cuda(pts.double(), 4)
    with pytest.raises(ValueError):
        fps_tiles_cuda(_tiles(1, 8193, cuda), 4)
    x = torch.zeros(4, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sc_matmul_cuda(x, x, n_planes=5)
    with pytest.raises(ValueError):
        sc_matmul_cuda(x.float(), x)
    with pytest.raises(ValueError, match="xla"):
        knn3(pts, pts, backend="xla")
    with pytest.raises(ValueError):
        knn3_cuda(pts.double(), pts.double())
    with pytest.raises(ValueError, match="contiguous"):
        knn3_cuda(pts.transpose(1, 2).contiguous().transpose(1, 2), pts)
    with pytest.raises(ValueError):
        knn3_cuda(pts, pts, k=9)
    with pytest.raises(ValueError):
        knn3_cuda(pts, pts[:, :2].contiguous(), k=3)
    with pytest.raises(ValueError):
        lattice_query_cuda(pts, pts, nsample=4, l_range=0.5)  # 3-D: use the per-tile wrapper


# -- delayed aggregation's gather + masked max-pool (csrc/group_pool.cu) ---------------

# The closed-loop benchmark cells: (config, clouds a batch, quant).
CELLS = {"seg-sc-b16": (SEG_CONFIG, 16, "sc_w16a16"), "cls-sc-b64": (CONFIG, 64, "sc_w16a16"),
         "cls-fp32-b64": (CONFIG, 64, "none")}


def _bitwise(got, want):
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


@contextlib.contextmanager
def _group_maxpool_plain_on_the_card():
    """The op's CUDA slot given its plain version, the composition the kernel
    replaced (take_along_dim, then masked_maxpool), inside the block."""
    spec = registry.get("group_maxpool")
    registry.register("group_maxpool", plain=spec.plain, cuda=spec.plain)
    try:
        yield
    finally:
        registry.register("group_maxpool", plain=spec.plain, cuda=spec.cuda)


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("stage", [0, 1])
def test_group_maxpool_kernel_at_the_cells_sa_shapes(cuda, cell, stage):
    """Each SA stage of each benchmark cell, neighbourhoods from the real engine on
    generated clouds, seeded features: the kernel == its plain version, bitwise."""
    cfg, b, quant = CELLS[cell]
    accel = get_accelerator(cfg, ExecutionPolicy(quant=quant), device=cuda)
    nbrs = accel.preprocess_stage(_clouds_for(cfg, 1, seed=60 + stage, b=b)[0])[stage].neighbors
    n = cfg.n_points if stage == 0 else cfg.sa[stage - 1].n_centroids
    c = cfg.sa[stage].mlp[-1]
    assert nbrs.idx.shape == (b, cfg.sa[stage].n_centroids, cfg.sa[stage].nsample)
    assert nbrs.idx.dtype == torch.int32 and c in (128, 256)
    g = torch.Generator(device=cuda).manual_seed(stage)
    features = torch.relu(torch.randn(b, n, c, generator=g, device=cuda))
    got = group_maxpool_cuda(features, nbrs.idx, nbrs.mask)
    torch.cuda.synchronize()
    assert _bitwise(got, group_maxpool_plain(features, nbrs.idx, nbrs.mask))


@pytest.mark.parametrize("c", [1, 3, 128, 256])
@pytest.mark.parametrize("s", [1, 16, 32])
@pytest.mark.parametrize("aligned", [True, False])
def test_group_maxpool_kernel_edge_cases(cuda, c, s, aligned):
    """All-masked centroids (0), a centroid with every slot valid and values below
    the -1e30 sentinel, a NaN row, ties, and a table 4 B past a 16 B boundary
    (the scalar lanes), against the plain version, bitwise."""
    b, n, m = 3, 50, 40
    g = torch.Generator(device=cuda).manual_seed(c * 100 + s)
    table = torch.round(torch.randn(b, n, c, generator=g, device=cuda) * 2) / 2 + 0.0
    if not aligned:
        buf = torch.empty(table.numel() + 1, device=cuda)
        buf[1:] = table.reshape(-1)
        table = buf[1:].view(b, n, c)
        assert table.data_ptr() % 16 == 4 and table.is_contiguous()
    idx = torch.randint(0, n, (b, m, s), generator=g, device=cuda, dtype=torch.int32)
    mask = torch.rand(b, m, s, generator=g, device=cuda) > 0.4
    mask[0, :5] = False
    mask[1, 0] = True
    table[1, idx[1, 0]] = -1e38
    mask[2, 3, 0] = True
    table[2, idx[2, 3, 0], c // 2] = float("nan")
    got = group_maxpool_cuda(table, idx, mask)
    torch.cuda.synchronize()
    want = group_maxpool_plain(table, idx, mask)
    assert _bitwise(got, want)
    assert torch.equal(got[0, :5], torch.zeros(5, c, device=cuda))
    assert torch.isnan(got[2, 3, c // 2])


def test_group_maxpool_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    f = torch.zeros(2, 10, 8, device=cuda)
    idx = torch.zeros(2, 4, 3, dtype=torch.int32, device=cuda)
    mask = torch.ones(2, 4, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="xla"):
        group_maxpool(f, idx, mask, backend="xla")
    with pytest.raises(ValueError):
        group_maxpool_cuda(f.double(), idx, mask)
    with pytest.raises(ValueError):
        group_maxpool_cuda(f, idx.long(), mask)
    with pytest.raises(ValueError):
        group_maxpool_cuda(f, idx, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        group_maxpool_cuda(f.transpose(1, 2).contiguous().transpose(1, 2), idx, mask)
    with pytest.raises(ValueError):
        group_maxpool_cuda(f, idx, mask[:, :3].contiguous())
    with pytest.raises(ValueError):
        group_maxpool_cuda(f[:1].contiguous(), idx, mask)
    with pytest.raises(ValueError):
        group_maxpool_cuda(f, idx[..., :0].contiguous(), mask[..., :0].contiguous())
    with pytest.raises(ValueError):
        group_maxpool_cuda(f, idx.cpu(), mask)
    assert group_maxpool_cuda(f[..., :0].contiguous(), idx, mask).shape == (2, 4, 0)


@pytest.mark.parametrize("cell", list(CELLS))
def test_group_maxpool_cell_forward_replays_equal_the_composition(cuda, cell):
    """At each cell's batch: every group_maxpool call of an eager forward (2, one
    an SA stage) == its plain version, bitwise; a graphed replay on another
    batch launches 2 and equals an eager forward through the composition the
    kernel replaced (take_along_dim, masked_maxpool) bitwise."""
    cfg, b, quant = CELLS[cell]
    accel = get_accelerator(cfg, ExecutionPolicy(quant=quant), device=cuda)
    params = accel.init(torch.Generator().manual_seed(5))
    cap, new = _clouds_for(cfg, 2, seed=70, b=b)
    calls = []
    spec = registry.get("group_maxpool")

    def record(*args):
        calls.append([a.clone() for a in args])
        return spec.cuda(*args)

    registry.register("group_maxpool", plain=spec.plain, cuda=record)
    try:
        with graphs.eager():
            accel.infer(params, cap)
    finally:
        registry.register("group_maxpool", plain=spec.plain, cuda=spec.cuda)
    assert len(calls) == len(cfg.sa)
    for args in calls:
        assert _bitwise(spec.cuda(*args), spec.plain(*args))
    accel.infer(params, cap)  # captures
    registry.reset_launches()
    got = accel.infer(params, new)
    torch.cuda.synchronize()
    assert registry.launches()["group_maxpool"] == len(cfg.sa)
    with _group_maxpool_plain_on_the_card(), graphs.eager():
        want = accel.infer(params, new)
    assert _bitwise(got, want)


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
def test_group_maxpool_sc_train_step_equals_the_composition(cuda, model, monkeypatch):
    """One SC step's loss and every gradient with the kernel (its backward the
    composition's, recomputed) equal autograd through the composition itself,
    bitwise, under deterministic kernels."""
    from repro_torch.models import pointnet2

    cfg = get_config(model)
    policy = ExecutionPolicy(quant="sc_w16a16")
    params = get_accelerator(cfg, policy, device=cuda).init(torch.Generator().manual_seed(6))
    pts, labels = _train_batches(cfg, 1, cuda, seed=3)[0]

    def step():
        loss, _ = pointnet2.loss_fn(params, cfg, pts, labels, policy=policy)
        return loss, torch.autograd.grad(loss, list(params.parameters()))

    with _deterministic(), graphs.eager():
        registry.reset_launches()
        loss, grads = step()
        assert registry.launches()["group_maxpool"] == len(cfg.sa)
        monkeypatch.setattr(G, "aggregate_delayed", lambda x, nbrs, mlp_fn, backend="auto":
                            G.masked_maxpool(G.group_features(mlp_fn(x), nbrs), nbrs.mask))
        registry.reset_launches()
        want_loss, want_grads = step()
        assert registry.launches()["group_maxpool"] == 0
    assert _bitwise(loss, want_loss)
    for got, want in zip(grads, want_grads):
        assert _bitwise(got, want)
    assert any(bool(g.abs().sum() > 0) for g in grads)


# -- the serving path on the card: streams, replicas, host reads ---------------


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_pipelined_two_streams_equal_sequential_infer(cuda, quant):
    """infer_pipelined (preprocess and feature streams, two threads) over 4
    full-width micro-batches: each bitwise equal to a default-stream infer."""
    accel = get_accelerator(CONFIG, ExecutionPolicy(quant=quant), device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batches = [rng.uniform(-1, 1, (BATCH, CONFIG.n_points, 3)).astype(np.float32)
               for _ in range(4)]
    registry.reset_launches()
    got = accel.infer_pipelined(params, batches)
    torch.cuda.synchronize()
    assert registry.launches()["fps_tiles"] == 2 * len(batches)
    for g, b in zip(got, batches):
        assert torch.equal(g, accel.infer(params, b))


def test_runtime_two_replicas_on_one_card_equal_direct_infer(cuda):
    """Two replicas (each with its own params copy and streams) on one card, 16
    ragged clouds: every response bitwise equal to a default-stream infer of
    the padded micro-batch it rode in, rebuilt from the batch records."""
    from repro_torch.serve import Request, RuntimeConfig, ServingRuntime, assemble_batch

    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    clouds = [rng.uniform(-1, 1, (int(n), 3)).astype(np.float32)
              for n in rng.integers(600, 1500, 16)]
    rt = ServingRuntime(CONFIG, params, RuntimeConfig(max_batch=BATCH, n_replicas=2),
                        device=cuda)
    try:
        futs = [rt.submit(c) for c in clouds]  # queued before start: two full batches
        rt.start()
        outs = [f.result(timeout=300) for f in futs]
    finally:
        rt.stop()
    deadline = time.monotonic() + 60  # a batch is recorded after its responses
    while sum(b.n_real for b in rt.metrics.batch_records) < len(clouds):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    records = [b for b in rt.metrics.batch_records if b.n_real]
    assert sorted(b.n_real for b in records) == [BATCH, BATCH]
    assert {b.replica_id for b in records} == {0, 1}
    assert all(r.params is not params for r in rt.pool.replicas)
    for lo in (0, BATCH):
        reqs = [Request(id=i, cloud=c, n_orig=c.shape[0], bucket=CONFIG.n_points,
                        policy=rt.default_policy, deadline_t=None, submit_t=0.0, future=None)
                for i, c in enumerate(clouds[lo:lo + BATCH])]
        batch = assemble_batch(reqs, CONFIG.n_points, 3, BATCH)
        direct = accel.infer(params, batch).cpu().numpy()
        for i in range(BATCH):
            np.testing.assert_array_equal(outs[lo + i], direct[i])


def test_result_to_host_reads_a_side_streams_finished_values(cuda):
    """A tensor written on a side stream behind a long spin: result_to_host,
    called from the default stream's thread, still reads the written values."""
    from repro_torch.core.engine import result_to_host
    from repro_torch.core.preprocess import PreprocessResult
    from repro_torch.core.query import NeighborSet

    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        idx = torch.zeros((8, 1 << 20), dtype=torch.int32, device=cuda)
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning before the writes
        idx.fill_(7)
        xyz = torch.full((8, 64, 3), 0.5, device=cuda)
        res = PreprocessResult(idx, xyz, NeighborSet(idx[:, :4], idx[:, :4] > 0),
                               torch.ones((8, 64), dtype=torch.bool, device=cuda))
    host = result_to_host((res,))
    assert (host[0].centroid_idx == 7).all() and (host[0].centroid_xyz == 0.5).all()
    assert host[0].neighbors.mask.all()


# -- captured graphs (core/graphs.py): replays against graphs.eager() ---------------


def _clouds_for(cfg, k, seed, b=BATCH):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (b, cfg.n_points, 3)).astype(np.float32) for _ in range(k)]


def _same_tree(got, want):
    got, want = result_leaves(got), result_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_every_entry_point_replays_bitwise_equal_to_eager(cuda, model, smoke, quant):
    """Captured on one batch, replayed on another: infer, infer_with_preprocess
    (every leaf), preprocess_stage, feature_stage and feature_from_cached (a
    host tree) equal graphs.eager() on that batch; replays capture nothing."""
    cfg = get_config(model, smoke=smoke)
    accel = get_accelerator(cfg, ExecutionPolicy(quant=quant), device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    cap, new = _clouds_for(cfg, 2, seed=10)
    accel.feature_stage(params, cap, accel.preprocess_stage(cap))
    accel.infer(params, cap)
    with graphs.eager():
        logits, pre = accel.infer_with_preprocess(params, new)
        host = result_to_host(pre)
        feat = accel.feature_stage(params, new, pre)
        cached = accel.feature_from_cached(params, new, host)
    before = graphs.captures()
    assert torch.equal(accel.infer(params, new), logits)
    _same_tree(accel.infer_with_preprocess(params, new), (logits, pre))
    _same_tree(accel.preprocess_stage(new), pre)
    assert torch.equal(accel.feature_stage(params, new, pre), feat)
    assert torch.equal(accel.feature_from_cached(params, new, host), cached)
    assert graphs.captures() == before


def test_replays_on_a_side_stream_equal_the_default_stream(cuda):
    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    batches = _clouds_for(CONFIG, 3, seed=11)
    on_default = [accel.infer(params, b) for b in batches]  # the first captures
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        on_side = [accel.infer(params, b) for b in batches]
        pre_side = accel.preprocess_stage(batches[1])  # the side stream's own graph
    torch.cuda.synchronize()
    with graphs.eager():
        want = [accel.infer(params, b) for b in batches]
        pre = accel.preprocess_stage(batches[1])
    for a, b, w in zip(on_default, on_side, want):
        assert torch.equal(a, w) and torch.equal(b, w)
    _same_tree(pre_side, pre)


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_pipelined_graphs_equal_sequential_infer_over_8_batches(cuda, quant):
    """8 distinct micro-batches through the pipelined pair (preprocess graph
    on one stream, feature graph on the other), twice: bitwise equal to
    sequential infer and to eager."""
    accel = get_accelerator(CONFIG, ExecutionPolicy(quant=quant), device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    batches = _clouds_for(CONFIG, 8, seed=12)
    sequential = [accel.infer(params, b) for b in batches]
    first = accel.infer_pipelined(params, batches)
    again = accel.infer_pipelined(params, batches[::-1])[::-1]
    torch.cuda.synchronize()
    with graphs.eager():
        want = [accel.infer(params, b) for b in batches]
    for s, a, b, w in zip(sequential, first, again, want):
        assert torch.equal(s, w) and torch.equal(a, w) and torch.equal(b, w)


@pytest.mark.parametrize("order", [(1, 0), (0, 1)], ids=["pre_on_1", "pre_on_0"])
def test_pipelined_graphs_across_two_cards_equal_eager_infer(cuda, order, monkeypatch):
    """The executor of an accelerator on card 0 with its stages on two cards,
    8 distinct micro-batches: stage A replays through devices[0]'s
    accelerator (card 0's own or not) and its preprocessing lies there,
    stage B runs on devices[1], and every answer lies on devices[1],
    bitwise equal to eager infer on card 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core.accelerator import PipelinedExecutor

    accel = get_accelerator(CONFIG, device="cuda:0")
    params = accel.init(torch.Generator().manual_seed(0))
    batches = _clouds_for(CONFIG, 8, seed=18)
    devices = [torch.device("cuda", i) for i in order]
    accel_pre = get_accelerator(CONFIG, device=devices[0])
    real, seen = accel_pre.preprocess_stage, []

    def preprocess_stage(pts):
        out = real(pts)
        seen.extend(t.device for t in result_leaves(out))
        return out

    monkeypatch.setattr(accel_pre, "preprocess_stage", preprocess_stage)
    ex = PipelinedExecutor(accel, devices=devices)
    first = ex.run(params, batches)
    assert seen and set(seen) == {devices[0]}
    again = ex.run(params, batches[::-1])[::-1]
    for d in devices:
        torch.cuda.synchronize(d)
    with graphs.eager():
        want = [accel.infer(params, b) for b in batches]
    for a, b, w in zip(first, again, want):
        assert a.device == devices[1] and b.device == devices[1]
        assert torch.equal(a.to(w.device), w) and torch.equal(b.to(w.device), w)


def test_infer_with_preprocess_tree_survives_the_next_replay(cuda):
    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    b0, b1, b2 = _clouds_for(CONFIG, 3, seed=13)
    accel.infer_with_preprocess(params, b0)  # captures
    kept = accel.infer_with_preprocess(params, b1)
    later = accel.infer_with_preprocess(params, b2)
    torch.cuda.synchronize()
    with graphs.eager():
        want1 = accel.infer_with_preprocess(params, b1)
        want2 = accel.infer_with_preprocess(params, b2)
    _same_tree(kept, want1)
    _same_tree(later, want2)
    assert not torch.equal(kept[1][0].centroid_xyz, later[1][0].centroid_xyz)


def test_capture_while_a_cache_fill_thread_reads_to_host(cuda):
    """New shapes captured while another thread keeps synchronising the
    device in result_to_host, as the cache-fill thread does."""
    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    tree = accel.preprocess_stage(_clouds_for(CONFIG, 1, seed=14)[0])
    stop, errors, reads = threading.Event(), [], [0]

    def reader():
        while not stop.is_set():
            try:
                result_to_host(tree)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
                return
            reads[0] += 1

    thread = threading.Thread(target=reader)
    thread.start()
    try:
        for b in (2, 4):
            x = _clouds_for(CONFIG, 1, seed=15 + b, b=b)[0]
            with graphs.eager():
                want = accel.infer(params, x)
            before = graphs.captures()
            first = accel.infer(params, x)
            got = accel.infer(params, x)
            assert graphs.captures() == before + 1
            assert torch.equal(first, want) and torch.equal(got, want)
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive() and not errors and reads[0] > 0


def test_capture_while_another_thread_runs_float_matmuls_eagerly(cuda):
    """Captures clear every thread's cuBLAS workspaces (core/graphs.py):
    new shapes captured while another thread loops full-width float infers
    eagerly on a stream of its own, as a serving replica's worker does
    beside a rejoin.  Every eager answer stays bitwise the one computed
    alone, and every capture's replays equal eager."""
    cfg = get_config("pointnet2-cls")
    accel = get_accelerator(cfg, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    x0 = _clouds_for(cfg, 1, seed=16)[0]
    with graphs.eager():
        want0 = accel.infer(params, x0).cpu()
    stop, warm, errors, loops = threading.Event(), threading.Event(), [], [0]

    def worker():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side), graphs.eager():
            while not stop.is_set():
                got = accel.infer(params, x0).cpu()  # waits on this stream only
                if not torch.equal(got, want0):
                    errors.append(f"eager answer {loops[0]} differs from the one computed alone")
                    break
                loops[0] += 1
                warm.set()  # the first call made this thread's cuBLAS handle
        warm.set()

    thread = threading.Thread(target=worker)
    thread.start()
    try:
        assert warm.wait(timeout=60)
        for b in (1, 2, 3, 5, 6, 7):
            x = _clouds_for(cfg, 2, seed=17 + b, b=b)
            before = graphs.captures()
            accel.infer(params, x[0])
            assert graphs.captures() == before + 1
            got = accel.infer(params, x[1])
            with graphs.eager():
                want = accel.infer(params, x[1])
            assert torch.equal(got, want)
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors and loops[0] > 0


def test_a_collection_during_a_capture_destroys_no_graph(cuda):
    """A graph left in a reference cycle, then a capture whose work
    allocates enough objects to start a cyclic collection: the collector is
    off inside a capture, so the old graph is not destroyed there (which
    would invalidate the capture), and it goes at the next collection."""
    cache = graphs.ArtifactCache(cuda)
    x = torch.arange(8, dtype=torch.float32, device=cuda)
    doomed = torch.nn.Linear(2, 2).to(cuda)
    cache.run(doomed, "probe", lambda t: (t * 2,), [x])
    gone = weakref.ref(doomed)
    loop = [doomed]
    loop.append(loop)
    del doomed, loop  # now only a collection frees the module and its graph
    seen = []

    def burst(t):
        seen.append(gc.isenabled())
        junk = [[] for _ in range(20000)]  # past the young generation's threshold
        return (t * 3 + len(junk),)

    assert gc.isenabled()
    art = cache.ensure(None, "burst", burst, [x])
    assert seen == [False] and gc.isenabled()
    got = art.replay([x])[0]
    assert torch.equal(got, x * 3 + 20000)
    gc.collect()
    assert gone() is None


def _padded(clouds, policy):
    from repro_torch.serve import Request, assemble_batch

    reqs = [Request(id=i, cloud=c, n_orig=c.shape[0], bucket=CONFIG.n_points, policy=policy,
                    deadline_t=None, submit_t=0.0, future=None) for i, c in enumerate(clouds)]
    return assemble_batch(reqs, CONFIG.n_points, 3, BATCH)


def _wait(cond, what):
    deadline = time.monotonic() + 60
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_warm_rejoin_captures_and_traffic_captures_nothing(cuda):
    """A cached runtime: the rejoined replica's warmup captures its three
    graphs (forward, preprocess, feature); two rounds of traffic afterwards (all-miss, then all-hit) capture
    none and answer bitwise as an eager infer of each padded batch."""
    from repro_torch.serve import RuntimeConfig, ServingRuntime

    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(16)
    clouds = [rng.uniform(-1, 1, (int(n), 3)).astype(np.float32)
              for n in rng.integers(600, 1500, 2 * BATCH)]
    rt = ServingRuntime(CONFIG, params, RuntimeConfig(max_batch=BATCH, max_wait_s=1.0,
                                                      cache_max_bytes=1 << 26), device=cuda)
    try:
        rt.warmup()
        rt.pool.evict(0, reason="test")
        before = graphs.captures()
        assert rt.pool.rejoin(0)
        assert graphs.captures() > before
        rep, zeros = rt.pool.replicas[0], np.zeros((BATCH, CONFIG.n_points, 3), np.float32)
        with graphs.eager():
            pre = accel.preprocess_stage(zeros)
        assert accel.artifacts.get(rep.params, "forward", [zeros]) is not None
        assert accel.artifacts.get(rep.params, "feature", [zeros, *result_leaves(pre)])
        with torch.cuda.stream(rep.stream):  # the preprocess graph of the replica's stream
            assert accel.artifacts.get(None, "preprocess", [zeros]) is not None
        warm = graphs.captures()
        futs = [rt.submit(c) for c in clouds]  # queued before start: full batches in order
        rt.start()
        first = [f.result(timeout=300) for f in futs]
        _wait(lambda: rt.cache.stats().insertions >= len(clouds), "cache fills")
        second = [f.result(timeout=300) for f in [rt.submit(c) for c in clouds]]
        assert graphs.captures() == warm
    finally:
        rt.stop()
    _wait(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= 2 * len(clouds),
          "batch records")
    assert sum(b.preprocess_skipped for b in rt.metrics.batch_records) == 2
    for lo in (0, BATCH):
        with graphs.eager():
            want = accel.infer(params, _padded(clouds[lo:lo + BATCH], rt.default_policy))
        want = want.cpu().numpy()
        for i in range(BATCH):
            np.testing.assert_array_equal(first[lo + i], want[i])
            np.testing.assert_array_equal(second[lo + i], want[i])


@pytest.mark.parametrize("pipeline", ["sequential", "pipelined"])
def test_partial_all_hit_sc_batch_equals_eager_infer_of_the_padded_batch(cuda, pipeline):
    """One SC request twice through the cache, every 1-D param drawn N(0, 2^2):
    the all-hit batch's filler rows carry the zero cloud's preprocessing, so
    it answers bitwise as an eager infer of the padded batch."""
    from repro_torch.serve import RuntimeConfig, ServingRuntime

    policy = ExecutionPolicy(quant="sc_w16a16", pipeline=pipeline)
    accel = get_accelerator(CONFIG, policy, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(17)
    with torch.no_grad():
        for p in params.parameters():
            if p.ndim == 1:
                p.copy_(torch.from_numpy(rng.normal(0.0, 2.0, p.shape).astype(np.float32)))
    cloud = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
    rt = ServingRuntime(CONFIG, params, RuntimeConfig(max_batch=BATCH, cache_max_bytes=1 << 26),
                        policy=policy, device=cuda)
    try:
        rt.warmup()
        rt.start()
        first = rt.infer(cloud)
        _wait(lambda: rt.cache.stats().insertions >= 1, "cache fill")
        second = rt.infer(cloud)
    finally:
        rt.stop()
    _wait(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= 2, "batch records")
    assert [b.preprocess_skipped for b in rt.metrics.batch_records if b.n_real] == [False, True]
    with graphs.eager():
        want = accel.infer(params, _padded([cloud], accel.policy)).cpu().numpy()[0]
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)


# -- the serving control plane on the card ----------------------------------------

# Bound on memory_allocated over kill -> rejoin cycles of one replica, above
# the reading after the first cycle.  chip_smoke's control-plane phase
# measured (NVIDIA H100 80GB HBM3, 700 W): one cls replica 6.65 MiB, its
# params copy 5.59 MiB and its float and SC graphs at 8x1024 1.05 MiB; no
# growth a cycle once the allocator has counted the dead replica's frees,
# which lag its last Python reference by up to a second.  1 MiB is below one
# replica's graphs, so a cycle that leaks them fails.
REJOIN_GROWTH_BOUND = 1 << 20
SETTLE_S = 5.0  # how long a reading waits for the dead replica's frees to count


def _zero_mb(policy, bucket=CONFIG.n_points, batch=None):
    from repro_torch.serve import MicroBatch

    return MicroBatch(requests=(), bucket=bucket, policy=policy,
                      batch=batch if batch is not None
                      else np.zeros((BATCH, bucket, 3), np.float32))


def _padded_at(clouds, policy, bucket):
    from repro_torch.serve import Request, assemble_batch

    reqs = [Request(id=i, cloud=c, n_orig=c.shape[0], bucket=bucket, policy=policy,
                    deadline_t=None, submit_t=0.0, future=None) for i, c in enumerate(clouds)]
    return assemble_batch(reqs, bucket, 3, BATCH)


def test_rejoin_capture_beside_a_replica_replaying_float_batches(cuda):
    """Replica 0 is evicted and rejoins (a fresh params copy, new streams, one
    float graph captured) while a thread keeps replica 1 replaying float
    batches: every answer on either side is bitwise the eager one."""
    from repro_torch.serve import ReplicaPool, ServeMetrics

    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    x = _clouds_for(CONFIG, 1, seed=30)[0]
    with graphs.eager():
        want = accel.infer(params, x).cpu().numpy()
    pool = ReplicaPool(CONFIG, params, n_replicas=2, device=cuda, metrics=ServeMetrics())
    stop, errors, loops = threading.Event(), [], [0]

    def traffic():
        while not stop.is_set():
            got = pool.submit(_zero_mb(accel.policy, batch=x)).result(timeout=60)
            if not np.array_equal(got, want):
                errors.append(f"replay {loops[0]} differs from eager")
                return
            loops[0] += 1

    thread = threading.Thread(target=traffic)
    try:
        pool.warmup(_zero_mb(accel.policy))
        pool.evict(0, reason="test")
        thread.start()
        _wait(lambda: loops[0] >= 3, "replica 1's replays")
        before, during = graphs.captures(), loops[0]
        assert pool.rejoin(0) and pool.replicas[0].alive
        assert graphs.captures() == before + 1
        stop.set()
        thread.join(timeout=60)
        assert not thread.is_alive() and not errors and loops[0] > during
        futs = [pool.submit(_zero_mb(accel.policy, batch=x)) for _ in range(4)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=60), want)
        assert pool.replicas[0].n_batches >= 2  # its warmup, then traffic
        assert graphs.captures() == before + 1
    finally:
        stop.set()
        thread.join(timeout=60)
        pool.shutdown()


def test_reconfigure_beside_a_thread_looping_eager_float_infers(cuda):
    """A bucket swap captures the new shape on both replicas (each capture
    clears every thread's cuBLAS workspaces) while another thread loops eager
    float infers on a stream of its own: every eager answer stays bitwise the
    one computed alone, and requests at the new bucket answer bitwise as an
    eager infer of their padded batch."""
    from repro_torch.serve import RuntimeConfig, ServingRuntime

    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    other = accel.init(torch.Generator().manual_seed(1))
    x0 = _clouds_for(CONFIG, 1, seed=31)[0]
    with graphs.eager():
        want0 = accel.infer(other, x0).cpu()
    stop, warm, errors, loops = threading.Event(), threading.Event(), [], [0]

    def worker():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side), graphs.eager():
            while not stop.is_set():
                if not torch.equal(accel.infer(other, x0).cpu(), want0):
                    errors.append(f"eager answer {loops[0]} differs from the one computed alone")
                    break
                loops[0] += 1
                warm.set()
        warm.set()

    rng = np.random.default_rng(32)
    clouds = [rng.uniform(-1, 1, (int(n), 3)).astype(np.float32)
              for n in rng.integers(300, 512, BATCH)]
    rt = ServingRuntime(CONFIG, params, RuntimeConfig(max_batch=BATCH, max_wait_s=1.0,
                                                      buckets=(CONFIG.n_points,), n_replicas=2),
                        device=cuda)
    thread = threading.Thread(target=worker)
    try:
        rt.warmup()
        rt.start()
        thread.start()
        assert warm.wait(timeout=60)
        before, during = graphs.captures(), loops[0]
        rt.reconfigure(buckets=(512, CONFIG.n_points))
        assert graphs.captures() == before + 2  # the 512 shape on each replica
        outs = [f.result(timeout=300) for f in [rt.submit(c) for c in clouds]]
        assert graphs.captures() == before + 2
        stop.set()
        thread.join(timeout=60)
        assert not thread.is_alive() and not errors and loops[0] > during
    finally:
        stop.set()
        thread.join(timeout=60)
        rt.stop()
    with graphs.eager():
        want = accel.infer(params, _padded_at(clouds, rt.default_policy, 512)).cpu().numpy()
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, want[i])


def test_kill_rejoin_cycles_keep_memory_bounded(cuda):
    """Six kill -> rejoin cycles of replica 0, float and SC graphs each time:
    the dead replica's params copy and graphs go with it, so memory_allocated
    stays within REJOIN_GROWTH_BOUND of its reading after the first cycle."""
    from repro_torch.core.device import CAPTURE_LOCK
    from repro_torch.serve import ReplicaPool, ServeMetrics

    sc = ExecutionPolicy(quant="sc_w16a16")
    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    pool = ReplicaPool(CONFIG, params, n_replicas=2, device=cuda, metrics=ServeMetrics())
    x = _clouds_for(CONFIG, 1, seed=33)[0]

    def collected(ref):
        with CAPTURE_LOCK:  # no collection beside a capture
            gc.collect()
        return ref() is None

    def allocated():
        with CAPTURE_LOCK:
            gc.collect()
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated(cuda)

    readings = []
    try:
        pool.warmup(_zero_mb(accel.policy))
        pool.warmup(_zero_mb(get_accelerator(CONFIG, sc, device=cuda).policy))
        for _ in range(6):
            dead = weakref.ref(pool.replicas[0])
            pool.evict(0, reason="test")
            assert pool.rejoin(0)
            for f in [pool.submit(_zero_mb(accel.policy, batch=x)) for _ in range(2)]:
                f.result(timeout=60)
            _wait(lambda: collected(dead), "the dead replica released")
            deadline = time.monotonic() + SETTLE_S
            while (readings and allocated() > readings[0] + REJOIN_GROWTH_BOUND
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            readings.append(allocated())
    finally:
        pool.shutdown()
    growth = max(readings) - readings[0]
    assert growth <= REJOIN_GROWTH_BOUND, [r - readings[0] for r in readings]


# -- training (launch/train.py): the step replayed as one CUDA graph ----------------------


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic kernels inside the block only (the backward's
    scatter-adds race otherwise); an op without one warns."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _train_batches(cfg, k, device, seed=0):
    from repro_torch.data.pointclouds import fold_in, sample_batch

    out = []
    for i in range(k):
        pts, cls, seg = sample_batch(fold_in(seed, 10_000 + i), BATCH, cfg.n_points, device=device)
        out.append((pts, cls if cfg.task == "cls" else seg))
    return out


def _fresh_step(accel, lr=1e-3):
    from repro_torch.launch.train import TrainStep
    from repro_torch.optim import adamw_init

    params = accel.init(torch.Generator().manual_seed(0))
    return TrainStep(accel, params, adamw_init(params), lr=lr)


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_train_step_replays_bitwise_equal_to_eager_steps(cuda, model, quant):
    """Four steps: the graphed step's first call runs eagerly and captures, the
    rest replay; every loss, parameter, moment and the step count equal four
    eager steps bitwise (deterministic kernels); a replay launches the
    forward's kernels, and only the first call captures."""
    cfg = get_config(model, smoke=True)
    accel = get_accelerator(cfg, ExecutionPolicy(quant=quant), device=cuda)
    batches = _train_batches(cfg, 4, cuda)
    registry.reset_launches()
    with graphs.eager():
        accel.infer(accel.init(torch.Generator().manual_seed(0)), batches[0][0])
    per_forward = registry.launches()
    with _deterministic():
        eager = _fresh_step(accel)
        with graphs.eager():
            want = [eager(*b) for b in batches]
        graphed = _fresh_step(accel)
        before = graphs.captures()
        got = [graphed(*batches[0])]
        registry.reset_launches()
        got += [graphed(*b) for b in batches[1:]]
        torch.cuda.synchronize()
        counts = registry.launches()
    assert graphs.captures() - before == 1
    assert counts == {n: 3 * v for n, v in per_forward.items()}
    assert per_forward["fps_tiles"] == per_forward["group_maxpool"] == 2
    assert (per_forward["sc_matmul"] > 0) == (quant != "none")
    for g, w in zip(got, want):
        assert set(g) == {"loss", "accuracy", "grad_norm"}
        for k in g:
            assert torch.equal(g[k], w[k]), k
    for a, b in zip(graphed._tensors(), eager._tensors()):
        assert torch.equal(a, b)
    assert int(graphed.state.step) == 4 and graphed.state.step.is_cuda


def test_train_step_replays_without_deterministic_kernels_close_to_eager(cuda):
    """With the default (racing) kernels the replay still trains: its losses
    stay within 1e-4 of eager steps' over three steps (float, smoke width)."""
    cfg = get_config("pointnet2-seg", smoke=True)
    accel = get_accelerator(cfg, device=cuda)
    batches = _train_batches(cfg, 3, cuda, seed=1)
    eager, graphed = _fresh_step(accel), _fresh_step(accel)
    with graphs.eager():
        want = [eager(*b)["loss"].item() for b in batches]
    got = [graphed(*b)["loss"].item() for b in batches]
    assert np.allclose(got, want, rtol=0, atol=1e-4), (got, want)


def test_train_step_captures_again_when_a_parameter_gets_new_storage(cuda):
    """A parameter given new storage (a restore by replacement) makes the next
    call capture again, and the steps go on as eager ones (bitwise under
    deterministic kernels)."""
    cfg = get_config("pointnet2-cls", smoke=True)
    accel = get_accelerator(cfg, device=cuda)
    batches = _train_batches(cfg, 3, cuda)
    with _deterministic():
        step = _fresh_step(accel)
        before = graphs.captures()
        step(*batches[0])
        step(*batches[1])
        assert graphs.captures() - before == 1
        lin = step.params.head.layers[0].lin
        lin.b.data = lin.b.detach().clone()
        step(*batches[2])
        assert graphs.captures() - before == 2
        with graphs.eager():
            ref = _fresh_step(accel)
            for b in batches:
                ref(*b)
    for a, b in zip(step._tensors(), ref._tensors()):
        assert torch.equal(a, b)


def test_checkpoint_round_trip_from_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.params import tree_leaves

    cfg = get_config("pointnet2-seg", smoke=True)
    step = _fresh_step(get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device=cuda))
    for b in _train_batches(cfg, 2, cuda):
        step(*b)
    tree = {"params": step.params, "opt": step.state}
    save_checkpoint(str(tmp_path), 2, tree)
    for device in (cuda, torch.device("cpu")):
        back, n, _ = load_checkpoint(str(tmp_path), tree, device=device)
        assert n == 2
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            assert b.device.type == device.type and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())
    # restored on the card, the step goes on from there
    back, _, _ = load_checkpoint(str(tmp_path), tree, device=cuda)
    from repro_torch.launch.train import TrainStep

    resumed = TrainStep(step.accel, back["params"], back["opt"], lr=step.lr)
    b = _train_batches(cfg, 3, cuda)[2]
    with _deterministic():
        assert torch.equal(resumed(*b)["loss"], step(*b)["loss"])


def test_train_entry_point_on_the_card(cuda, tmp_path, capsys):
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import main

    params = main(["--arch", "pointnet2-seg", "--smoke", "--steps", "4", "--quant", "sc_w16a16",
                   "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"])
    assert next(params.parameters()).is_cuda
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 4 and latest_step(str(tmp_path)) == 4


def test_sample_batch_on_the_card(cuda):
    from repro_torch.data.pointclouds import N_CLASSES, sample_batch

    a = sample_batch(3, 8, 1024, device=cuda)
    b = sample_batch(3, 8, 1024, device=cuda)
    assert all(x.is_cuda and torch.equal(x, y) for x, y in zip(a, b))
    pts, cls, seg = a
    assert pts.dtype == torch.float32 and cls.dtype == seg.dtype == torch.int64
    assert bool(((cls >= 0) & (cls < N_CLASSES)).all()) and bool(torch.isfinite(pts).all())


def test_loss_graph_replays_equal_eager(cuda):
    cfg = get_config("pointnet2-seg", smoke=True)
    accel = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    (p0, l0), (p1, l1) = _train_batches(cfg, 2, cuda)
    before = graphs.captures()
    accel.loss(params, p0, l0)
    got = accel.loss(params, p1, l1.cpu().numpy().astype(np.int32))  # host labels, as int64
    with graphs.eager():
        want = accel.loss(params, p1, l1)
    assert graphs.captures() - before == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1]["accuracy"], want[1]["accuracy"])


# -- multi-device: sharded artifacts, sharded serving, pipeline_forward -------
#
# SC sharded logits must equal single-device eager infer bitwise (integer
# products, per-element float ops).  Float ones are held bitwise or, where
# cuBLAS sums the matmul of a shard's row or column block in another order
# than the whole product's, within SHARD_FLOAT_ATOL, the card-vs-CPU bound
# of chip_smoke.py (LOGIT_ATOL), which also names the matmuls that differ.
SHARD_FLOAT_ATOL = 1e-4


def _sharded_equal(got, want, quant):
    got = got.to(want.device)
    assert got.shape == want.shape and torch.isfinite(got).all()
    if quant == "none":
        torch.testing.assert_close(got, want, rtol=0, atol=SHARD_FLOAT_ATOL)
    else:
        assert torch.equal(got, want), (got - want).abs().max().item()


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return (torch.device("cuda", 0), torch.device("cuda", 1))


def _sharded_parity(group, model, smoke):
    cfg = get_config(model, smoke=smoke)
    params = get_accelerator(cfg, device="cuda:0").init(torch.Generator().manual_seed(3))
    batch = _clouds_for(cfg, 1, seed=40)[0]
    for quant in ("none", "sc_w16a16"):
        single = get_accelerator(cfg, ExecutionPolicy(quant=quant), device="cuda:0")
        with graphs.eager():
            want = single.infer(params, batch)
        per_forward = {"fps_tiles": len(cfg.sa), "lattice_tiles": len(cfg.sa),
                       "knn3": len(cfg.sa) if cfg.task == "seg" else 0,
                       "group_maxpool": len(cfg.sa)}
        for mode in ("batch", "tensor"):
            arts = get_accelerator(cfg, ExecutionPolicy(quant=quant, sharding=mode),
                                   device=group[0]).mesh_artifacts(group)
            registry.reset_launches()
            got = arts.infer(params, batch)
            for d in set(group):
                torch.cuda.synchronize(d)
            counts = registry.launches()
            for name, n in per_forward.items():
                assert counts[name] == n * len(group), (name, counts)
            assert (counts["sc_matmul"] > 0) == (quant != "none")
            assert got.device == group[0]
            _sharded_equal(got, want, quant)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
def test_sharded_parity_on_two_cards(cuda, model, smoke):
    _sharded_parity(_two_cards(), model, smoke)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
def test_sharded_parity_on_two_shards_of_one_card(cuda, model, smoke):
    _sharded_parity((torch.device("cuda", 0),) * 2, model, smoke)


@pytest.mark.parametrize("mode", ["batch", "tensor"])
def test_sharded_infer_sees_params_updated_in_place_across_cards(cuda, mode):
    """One params module is placed on the group anew at every call, so
    weights loaded into it in place between two calls (as an optimizer step
    or `load_state_dict` does) reach the shard on the other card."""
    group = _two_cards()
    cfg = get_config("pointnet2-cls", smoke=True)
    single = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16"), device=group[0])
    params = single.init(torch.Generator().manual_seed(3))
    batch = _clouds_for(cfg, 1, seed=41)[0]
    arts = get_accelerator(cfg, ExecutionPolicy(quant="sc_w16a16", sharding=mode),
                           device=group[0]).mesh_artifacts(group)
    first = arts.infer(params, batch)
    params.load_state_dict(single.init(torch.Generator().manual_seed(4)).state_dict())
    with graphs.eager():
        want = single.infer(params, batch)
    got = arts.infer(params, batch)
    _sharded_equal(got, want, "sc_w16a16")
    assert not torch.equal(got, first)


def test_collectives_read_the_writers_finished_values(cuda):
    """Each shard makes its tensor with a long chain of kernels on its own
    stream and gathers at once: every reader sees the finished values (its
    stream waits on the writer's event), across cards and on one card."""
    from repro_torch.launch.mesh import ReplicaMesh
    from repro_torch.sharding import hints

    groups = [(torch.device("cuda", 0),) * 3]
    if torch.cuda.device_count() >= 2:
        groups.append((torch.device("cuda", 0), torch.device("cuda", 1)))
    for group in groups:
        mesh = ReplicaMesh(group)

        def body(i):
            x = torch.full((2048, 2048), 1.0, device=group[i])
            for _ in range(30):
                x = torch.sqrt(x * x + 0.0)  # slow-ish, value-preserving work
            x = x * (i + 1)
            return torch.cat([hints.all_gather(x[:4, :4], dim=0),
                              hints.all_max(x[:4, :4])])

        for _ in range(5):
            results = mesh.run(body)
            for out, ready in results:
                torch.cuda.current_stream(out.device).wait_event(ready)
                want = torch.cat([torch.full((4, 4), float(i + 1)) for i in range(len(group))]
                                 + [torch.full((4, 4), float(len(group)))])
                assert torch.equal(out.cpu(), want)


def test_sharded_runtime_beside_a_thread_replaying_unsharded_graphs(cuda):
    """A ServingRuntime with one replica over two shards of card 0 serves
    batch-float and tensor-SC traffic while another thread keeps replaying
    an unsharded graph on the same card: every response is its padded
    batch's eager infer (SC bitwise, float within SHARD_FLOAT_ATOL) and
    every replay is bitwise the first."""
    from repro_torch.serve import RuntimeConfig, ServingRuntime, TraceConfig

    accel = get_accelerator(CONFIG, device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    x = _clouds_for(CONFIG, 1, seed=41)[0]
    first = accel.infer(params, x).cpu()  # captures
    stop, errors, loops = threading.Event(), [], [0]

    def replays():
        while not stop.is_set():
            if not torch.equal(accel.infer(params, x).cpu(), first):
                errors.append(f"replay {loops[0]} differs")
                return
            loops[0] += 1

    rng = np.random.default_rng(5)
    clouds = [rng.uniform(-1, 1, (int(n), 3)).astype(np.float32)
              for n in rng.integers(600, 1500, 4 * BATCH)]
    pols = [ExecutionPolicy(sharding="batch"), ExecutionPolicy(quant="sc_w16a16",
                                                               sharding="tensor")]
    rt = ServingRuntime(CONFIG, params, RuntimeConfig(max_batch=BATCH, devices_per_replica=2,
                                                      trace=TraceConfig()),
                        devices=[cuda, cuda])
    thread = threading.Thread(target=replays)
    try:
        rt.warmup(tuple(pols))
        thread.start()
        futs = [rt.submit(c, policy=pols[i % 2]) for i, c in enumerate(clouds)]
        rt.start()
        outs = [f.result(timeout=300) for f in futs]
    finally:
        stop.set()
        thread.join(timeout=60)
        rt.stop()
    assert not thread.is_alive() and not errors and loops[0] > 0
    events = rt.tracer.events()
    order = {e.trace_id: k for k, e in enumerate(e for e in events if e.name == "request.submit")}
    from repro_torch.serve import Request, assemble_batch
    seen = 0
    for e in events:
        if e.name != "batch.assembled":
            continue
        idx = [order[t] for t in e.args["members"]]
        quant = pols[idx[0] % 2].quant
        reqs = [Request(id=i, cloud=clouds[i], n_orig=clouds[i].shape[0],
                        bucket=CONFIG.n_points, policy=None, deadline_t=None, submit_t=0.0,
                        future=None) for i in idx]
        with graphs.eager():
            want = get_accelerator(CONFIG, ExecutionPolicy(quant=quant), device=cuda).infer(
                params, assemble_batch(reqs, CONFIG.n_points, 3, BATCH))
        for j, i in enumerate(idx):
            assert pols[i % 2].quant == quant
            _sharded_equal(torch.from_numpy(outs[i]), want[j].cpu(), quant)
            seen += 1
    assert seen == len(clouds)


def test_pipeline_forward_across_the_cards(cuda):
    """Four stages over the cards present (stage s on card s % count) against
    the sequential composition, within the JAX test's 2e-5."""
    from repro_torch.parallel import pipeline_forward

    n = min(4, torch.cuda.device_count())
    devs = [torch.device("cuda", s % n) for s in range(4)]
    rng = np.random.default_rng(6)
    for mb, d in ((4, 16), (64, 1024)):
        w = torch.from_numpy((rng.standard_normal((4, d, d)) / np.sqrt(d)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((8, mb, d)).astype(np.float32)).cuda()
        got = pipeline_forward(devs, lambda wp, xx, s: torch.tanh(xx @ wp), w, x)
        ref = x
        for s in range(4):
            ref = torch.tanh(ref.to(devs[s]) @ w[s].to(devs[s]))
        torch.testing.assert_close(got, ref.to(x.device), rtol=2e-5, atol=2e-5)
        assert got.device == x.device and got.shape == x.shape


def test_a_kernel_on_another_card_leaves_the_current_device(cuda):
    """Each wrapper makes its tensor's card current for the launch only: a
    call on card 1 from a thread whose current device is card 0 leaves card
    0 current (the C entry points set the thread's current CUDA context,
    which PyTorch reads too)."""
    _two_cards()
    one = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    pts = torch.rand(4, 64, 3, device=one)
    fps_tiles_cuda(pts, 8)
    lattice_tiles_cuda(pts, pts[:, :8].contiguous(), nsample=4, l_range=0.5)
    knn3_cuda(pts, pts, k=3)
    q = torch.randint(-100, 100, (16, 8), dtype=torch.int32, device=one)
    sc_matmul_cuda(q, q.t().contiguous(), n_planes=4)
    torch.cuda.synchronize(one)
    assert torch.cuda.current_device() == 0


# -- the paper's comparison paths ---------------------------------------------------

# Baseline-1's global FPS, B clouds as the kernel's tiles: (T, P, k) of each SA
# stage of cls (8 x 1024) and seg (8 x 4096).
GLOBAL_FPS = [(BATCH, 1024, 256), (BATCH, 256, 64), (BATCH, 4096, 1024), (BATCH, 1024, 256)]
COMPARISON_CORNERS = [("baseline1", "standard"), ("baseline2", "standard"),
                      ("pc2im", "standard"), ("baseline1", "delayed"), ("baseline2", "delayed")]


def _standard_sa_shapes(cfg):
    """(M, K, N) of each SA layer under standard aggregation for BATCH clouds:
    every (centroid, neighbour) row through the MLP."""
    shapes, c_in = [], 3
    for sa in cfg.sa:
        rows = BATCH * sa.n_centroids * sa.nsample
        for c in sa.mlp:
            shapes.append((rows, c_in, c))
            c_in = c
        c_in += 3
    return shapes


def test_comparison_shapes():
    assert _standard_sa_shapes(CONFIG)[0] == (65536, 3, 64)
    assert _standard_sa_shapes(CONFIG)[3] == (16384, 131, 128)
    assert _standard_sa_shapes(SEG_CONFIG)[0] == (262144, 3, 64)
    assert _standard_sa_shapes(SEG_CONFIG)[3] == (65536, 131, 128)


@pytest.mark.parametrize("t,p,k", GLOBAL_FPS)
@pytest.mark.parametrize("snapped", [False, True])
def test_fps_kernel_l2_at_global_shapes(cuda, t, p, k, snapped):
    """Baseline-1: one tile a cloud, P up to 4096 (a 1024-thread block at 48 KiB
    of shared memory) and k up to 1024 sequential steps."""
    pts = _tiles(t, p, cuda, seed=p + k, snapped=snapped)
    got = fps_tiles_cuda(pts, k, metric="l2")
    torch.cuda.synchronize()
    assert torch.equal(got, fps_tiles_plain(pts, k, metric="l2"))


@pytest.mark.parametrize("shape", sorted(set(_standard_sa_shapes(CONFIG)
                                             + _standard_sa_shapes(SEG_CONFIG))))
def test_sc_matmul_kernel_at_standard_aggregation_rows(cuda, shape):
    """Standard aggregation's grouped rows: 16,384 to 262,144 rows a layer."""
    m, k, n = shape
    x, w = _int_operands(m, k, n, 16, cuda, seed=m + k + n)
    got = sc_matmul_cuda(x, w, n_planes=4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=4))


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("preproc,aggregation", COMPARISON_CORNERS)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_comparison_corner_replays_equal_eager(cuda, model, preproc, aggregation, quant):
    """Smoke width: each comparison corner's entry points replayed on a batch
    other than the captured one, bitwise equal to graphs.eager(); a replay's
    launches: baseline1 2 FPS, baseline2 none, pc2im 2 FPS + 2 lattice; SC
    12 matmuls; seg 2 knn3; delayed aggregation 2 group_maxpool."""
    cfg = dataclasses.replace(get_config(model, smoke=True), preproc=preproc,
                              aggregation=aggregation)
    accel = get_accelerator(cfg, ExecutionPolicy(quant=quant), device=cuda)
    params = accel.init(torch.Generator().manual_seed(0))
    cap, new = _clouds_for(cfg, 2, seed=11)
    new[1, :, 2] = 0.5  # planar: empty grid cells, padded centroids under baseline2
    accel.feature_stage(params, cap, accel.preprocess_stage(cap))
    accel.infer(params, cap)
    with graphs.eager():
        logits, pre = accel.infer_with_preprocess(params, new)
        host = result_to_host(pre)
    before = graphs.captures()
    registry.reset_launches()
    got = accel.infer(params, new)
    torch.cuda.synchronize()
    n_sc = (sum(len(sa.mlp) for sa in cfg.sa)
            + (len(cfg.global_mlp) if cfg.task == "cls" else 2 * len(cfg.sa))
            + len(cfg.head) + 1) if quant != "none" else 0
    want = {"fps_tiles": 0 if preproc == "baseline2" else 2,
            "lattice_tiles": 2 if preproc == "pc2im" else 0, "sc_matmul": n_sc,
            "knn3": 2 if cfg.task == "seg" else 0, "lattice_query": 0,
            "group_maxpool": 2 if aggregation == "delayed" else 0}
    assert registry.launches() == want
    assert torch.equal(got, logits)
    _same_tree(accel.preprocess_stage(new), pre)
    assert torch.equal(accel.feature_from_cached(params, new, host), logits)
    assert graphs.captures() == before


# -- dense LM serving ---------------------------------------------------------------------

LM_DENSE = ["stablelm-1.6b", "starcoder2-3b", "gemma3-12b", "command-r-plus-104b"]
# Card against the CPU at smoke width (float32): float with float caches as
# LOGIT_ATOL's reasons in chip_smoke.py; SC or int8 caches as tests/_lm.py's
# SC_LOGIT_ATOL (a float difference moves an activation across a quantizer
# boundary, or an int8 K/V value across one step: float with int8 caches
# measured 4.0e-4 on an H100, command-r-plus smoke).
LM_CPU_ATOL = {"float": 1e-4, "quantized": 5e-3}


def _lm_shapes():
    """(M, K, N) of the SC matmul in stablelm-1.6b (4 x 128 prompt, decode of 4)
    and gemma3-12b (2 x 1280 prompt, decode of 2) at full width."""
    shapes = []
    for m_pre, m_dec, d, q_out, kv_out, d_ff in ((512, 4, 2048, 2048, 2048, 5632),
                                                 (2560, 2, 3840, 4096, 2048, 15360)):
        for m in (m_pre, m_dec):
            shapes += [(m, d, q_out), (m, d, kv_out), (m, q_out, d), (m, d, d_ff), (m, d_ff, d)]
    return sorted(set(shapes))


def _record_sc(run):
    """run()'s result and every SC matmul call it made, inputs cloned."""
    spec = registry.get("sc_matmul")
    calls = []

    def record(*args, **kw):
        calls.append(([a.clone() for a in args], dict(kw)))
        return spec.cuda(*args, **kw)

    registry.register("sc_matmul", plain=spec.plain, cuda=record)
    try:
        out = run()
    finally:
        registry.register("sc_matmul", plain=spec.plain, cuda=spec.cuda)
    return out, calls


@pytest.mark.parametrize("shape", _lm_shapes())
@pytest.mark.parametrize("bits", [16, 8])
def test_sc_matmul_kernel_at_lm_shapes(cuda, shape, bits):
    """Every SC product of stablelm-1.6b and gemma3-12b serving at full width: K up
    to 15360 (the streaming kernel: w's planes do not fit in shared memory), split K
    for the decode rows."""
    m, k, n = shape
    x, w = _int_operands(m, k, n, bits, cuda, seed=m + k + n)
    got = sc_matmul_cuda(x, w, n_planes=bits // 4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=bits // 4))


@pytest.mark.parametrize("m,k,n", [(4, 2048, 5632), (512, 2048, 2048), (2000, 1024, 64)])
@pytest.mark.parametrize("bits", [16, 8])
def test_sc_matmul_kernel_takes_a_bf16_quantizers_largest_value(cuda, m, k, n, bits):
    """Under bf16 the quantizer's qmax 2^(b-1) - 1 rounds up to 2^(b-1), which it
    reaches (the reference does the same): its top plane is +8, not -8, through
    split K, the streaming and the resident kernel."""
    x, w = _int_operands(m, k, n, bits, cuda, seed=m + n)
    top = 1 << (bits - 1)
    x[:, ::3] = top
    w[::5] = -top
    w[1::7] = top
    got = sc_matmul_cuda(x, w, n_planes=bits // 4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=bits // 4))
    exact = (x.cpu().to(torch.int64) @ w.cpu().to(torch.int64)).double()
    assert (got.cpu().double() - exact).abs().max() <= 1e-6 * exact.abs().max()


def test_sc_matmul_kernel_at_the_deepest_lm_k(cuda):
    """command-r-plus-104b's d_ff, K = 33792, every operand 32767 (planes 15, 15,
    15, 7): the largest diagonal sum, 660 * K = 2.2e7, stays an exact int32."""
    x = torch.full((4, 33792), 32767, dtype=torch.int32, device=cuda)
    w = torch.full((33792, 64), 32767, dtype=torch.int32, device=cuda)
    got = sc_matmul_cuda(x, w, n_planes=4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=4))
    exact = 32767.0 * 32767.0 * 33792
    assert (got.double() - exact).abs().max() <= 1e-6 * exact


@pytest.mark.parametrize("name", LM_DENSE)
@pytest.mark.parametrize("quant,kv", [("none", "none"), ("none", "int8"), ("sc_w16a16", "none"),
                                      ("sc_w16a16", "int8"), ("sc_w8a8", "int8")])
def test_lm_smoke_serving_on_the_card(cuda, name, quant, kv):
    """Smoke width: prefill of 2 x 16 into caches of 24, then 3 decode steps fed the
    card's greedy tokens, on the card and on the CPU from the same params: every SC
    call bitwise equal to the plain version on the card, 7 per layer a step (6
    with starcoder2's dense MLP), the logits within LM_CPU_ATOL of the CPU's."""
    import copy

    from repro_torch.models import transformer as T
    from repro_torch.serve import make_serve_fns

    cfg = dataclasses.replace(get_config(name, smoke=True), kv_quant=kv)
    p_cpu = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    pol = ExecutionPolicy(quant=quant)
    fg, fc = make_serve_fns(cfg, pol, device=cuda), make_serve_fns(cfg, pol, device="cpu")
    batch = {"tokens": np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))}
    n_sc = (4 + (3 if cfg.mlp_kind == "glu" else 2)) * cfg.n_layers if quant != "none" else 0
    registry.reset_launches()
    (lg, sg), calls = _record_sc(lambda: fg["prefill"](p_gpu, batch, 24))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == len(calls) == n_sc
    lc, sc = fc["prefill"](p_cpu, batch, 24)
    diffs = [(lg.cpu() - lc).abs().max().item()]
    tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    for _ in range(3):
        registry.reset_launches()
        (lg, nxt, sg), more = _record_sc(lambda: fg["decode"](p_gpu, sg, {"token": tok}))
        torch.cuda.synchronize()
        assert registry.launches()["sc_matmul"] == len(more) == n_sc
        calls += more
        lc, _, sc = fc["decode"](p_cpu, sc, {"token": tok.cpu()})
        diffs.append((lg.cpu() - lc).abs().max().item())
        tok = nxt
    assert int(sg.cache_len) == 19
    for args, kw in calls:
        assert torch.equal(sc_matmul_cuda(*args, **kw), sc_matmul_plain(*args, **kw))
    assert max(diffs) <= LM_CPU_ATOL["float" if (quant, kv) == ("none", "none")
                                     else "quantized"], diffs


# -- dense LM training ---------------------------------------------------------------------

# Card against the CPU at smoke width (float32), one batch: the loss within
# LM_CPU_ATOL["float"] (float) or ["quantized"] (SC), the reasons above;
# gradients within LM_TRAIN_GRAD_REL of each leaf's max |g|: float as the
# matmul orders allow (~1e-6 relative a product, through 2-6 layers and the
# flash backward).  SC: the nonzero pattern above 1e-30, then 1e-2 for every
# leaf, a few times the worst reading.  A linear passes a gradient to its
# input only through its quantizer's amax, and the float ops around the
# bitwise SC kernel round otherwise on the card, so a one-quantum difference
# reaches every leaf through the scale path.  Measured (H100; the test
# prints its worst ratios under -rP), the largest over the norms' leaves /
# the other leaves with a max of at least 1e-3 / the others: stablelm 1.09e-3 / 1.09e-3 / 0, starcoder2 1.60e-3 / 1.60e-3
# / 1.60e-3, gemma3 7.3e-4 / 7.3e-4 / 2.19e-3, command-r-plus 1.1e-4 /
# 6.8e-5 / 0 of the leaf's max.
LM_TRAIN_GRAD_REL = {"none": 1e-4, "sc_w16a16": 1e-2}


def _lm_grads(cfg, params, batch, pol):
    from repro_torch.models import transformer as T
    from repro_torch.params import named_jax_params

    named = named_jax_params(params)
    loss, _ = T.lm_loss(params, cfg, batch, policy=pol)
    return loss.detach(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


@pytest.mark.parametrize("name", LM_DENSE)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_train_step_on_the_card_against_the_cpu(cuda, name, quant):
    """Smoke width, float32, remat full, 2 x 48 tokens: lm_loss and every gradient
    leaf on the card against the CPU from the same params.  Under SC every SC
    call of the step is bitwise equal to the plain version, and the step makes 2 x
    7 per layer (6 with starcoder2's dense MLP): each linear in the forward and
    again in the backward's recompute.  Then three make_train_step steps, whose
    losses stay within the same bound of the CPU's."""
    import copy

    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    cfg = get_config(name, smoke=True)
    p_cpu = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    pol = ExecutionPolicy(quant=quant)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32))
        batches.append({"tokens": toks, "labels": torch.roll(toks, -1, dims=1)})
    on_card = {k: v.to(cuda) for k, v in batches[0].items()}
    n_sc = 2 * (4 + (3 if cfg.mlp_kind == "glu" else 2)) * cfg.n_layers if quant != "none" else 0
    registry.reset_launches()
    (loss_gpu, g_gpu), calls = _record_sc(lambda: _lm_grads(cfg, p_gpu, on_card, pol))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == len(calls) == n_sc
    for args, kw in calls:
        assert torch.equal(sc_matmul_cuda(*args, **kw), sc_matmul_plain(*args, **kw))
    loss_cpu, g_cpu = _lm_grads(cfg, p_cpu, batches[0], pol)
    atol = LM_CPU_ATOL["float" if quant == "none" else "quantized"]
    assert abs(loss_gpu.item() - loss_cpu.item()) <= atol
    ratios, bad = {}, []
    for k, want in g_cpu.items():
        got = g_gpu[k].cpu().double()
        want = want.double()
        top = want.abs().max().item()
        if quant != "none" and not torch.equal(got.abs() > 1e-30, want.abs() > 1e-30):
            bad.append(f"{k}: nonzero pattern")
        if top > 1e-30:
            ratios[k] = (got - want).abs().max().item() / top
            if ratios[k] > LM_TRAIN_GRAD_REL[quant]:
                bad.append(f"{k}: {ratios[k]:.3e} of its max {top:.3e}")
    norms = [r for k, r in ratios.items() if {"ln1", "ln2", "final_norm"} & set(k.split("."))]
    print(f"{name} {quant}: gradients, the worst |card - cpu| / max: norms {max(norms):.3e}, "
          f"all {max(ratios.values()):.3e}")
    assert not bad, (bad, sorted(ratios.items(), key=lambda kv: -kv[1])[:6])
    step_gpu = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1, policy=pol)
    step_cpu = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1, policy=pol)
    s_gpu, s_cpu = adamw_init(p_gpu), adamw_init(p_cpu)
    for b in batches:
        _, _, m_gpu = step_gpu(p_gpu, s_gpu, {k: v.to(cuda) for k, v in b.items()})
        _, _, m_cpu = step_cpu(p_cpu, s_cpu, b)
        assert m_gpu["loss"].is_cuda
        assert abs(m_gpu["loss"].item() - m_cpu["loss"].item()) <= atol
    assert int(s_gpu.step) == 3


def test_lm_train_entry_point_on_the_card(tmp_path):
    """python -m repro_torch.launch.train on an LM smoke config, on the card by
    default, with checkpoints the CPU reads back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import main

    state = main(["--arch", "gemma3-12b", "--smoke", "--steps", "3", "--batch", "2",
                  "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert state["params"].embed.is_cuda and int(state["opt"].step) == 3
    assert latest_step(str(tmp_path)) == 3


def test_lm_train_checkpoint_stages_through_the_host(cuda, tmp_path):
    """An LM checkpoint of a train state on the card, saved and restored through
    LMCheckpoints, allocates no more on the card than its largest leaf (the
    layers are stacked on the host, and a restore copies leaf by leaf into the
    state's own tensors); the restored state equals the saved one bitwise."""
    import dataclasses

    from repro_torch.launch.train import LMCheckpoints
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.params import lm_state_to_tree, tree_leaves

    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True), dtype_str="bfloat16")

    def state(seed):
        params = T.init_lm(cfg, generator=torch.Generator(device=cuda).manual_seed(seed),
                           device=cuda)
        return {"params": params, "opt": adamw_init(params)}

    saved, fresh = state(0), state(1)
    leaves = tree_leaves(lm_state_to_tree(saved, device="meta"))
    largest = max(t.numel() * t.element_size() for t in leaves)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mgr = LMCheckpoints(str(tmp_path), every=1)
    assert mgr.maybe_save(1, saved)
    mgr.wait()
    restored, step, _ = mgr.restore_or_none(fresh)
    torch.cuda.synchronize()
    assert restored is fresh and step == 1
    assert torch.cuda.max_memory_allocated() - base <= largest
    assert fresh["params"].embed.is_cuda
    for a, b in zip(tree_leaves(lm_state_to_tree(saved, device="cpu")),
                    tree_leaves(lm_state_to_tree(fresh, device="cpu"))):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the moe, ssm and hybrid LM families ------------------------------------------------

LM_FAMILIES = ["granite-moe-3b-a800m", "dbrx-132b", "mamba2-1.3b", "recurrentgemma-2b"]


def _lm_families_shapes():
    """(M, K, N) of the SC matmul at the new families' full widths: the routers (K =
    d_model, N = E: granite 1536 -> 40, dbrx 6144 -> 16) at decode rows 2-4 and
    prefill rows; granite's and dbrx's attention projections; mamba2's in_proj
    (2048 -> 8512) and out_proj (4096 -> 2048); recurrentgemma's RG-LRU linears
    (2560 -> 2560), attention (2560 -> 2560 / 256) and GLU (2560 <-> 7680); at
    decode rows (2, 4), prefill rows (512, 4352) and training rows (2048)."""
    shapes = set()
    for m in (2, 3, 4, 512):
        shapes |= {(m, 1536, 40), (m, 6144, 16)}
    for m in (4, 512, 2048):
        shapes |= {(m, 1536, 1536), (m, 1536, 512), (m, 2048, 8512), (m, 4096, 2048)}
    for m in (2, 512):
        shapes |= {(m, 6144, 6144), (m, 6144, 1024)}
    for m in (2, 4352):
        shapes |= {(m, 2560, 2560), (m, 2560, 256), (m, 2560, 7680), (m, 7680, 2560)}
    return sorted(shapes)


def _family_sc_calls(cfg, train: bool = False) -> int:
    """SC matmuls of one forward step (train: one training step, remat full): 4 for
    attention, 1 for the MoE router, 2 for a Mamba-2 block, 5 for an RG-LRU block,
    3 for a GLU MLP; training recomputes every remat unit once more, but for the
    hybrid's remainder layers, which the reference does not remat."""
    from repro_torch.models.families import hybrid_geometry

    kinds = cfg.pattern_for_layers()
    if cfg.family == "ssm":
        per = [2] * cfg.n_layers
    elif cfg.family == "moe":
        per = [5] * cfg.n_layers
    else:
        per = [(5 if t == "recurrent" else 4) + 3 for t in kinds]
    if not train:
        return sum(per)
    rem = hybrid_geometry(cfg)[2] if cfg.family == "hybrid" else 0
    return 2 * sum(per) - sum(per[len(per) - rem:])


@pytest.mark.parametrize("shape", _lm_families_shapes())
@pytest.mark.parametrize("bits", [16, 8])
def test_sc_matmul_kernel_at_lm_families_shapes(cuda, shape, bits):
    """Every new shape of the moe, ssm and hybrid families, the N = 40 and N = 16
    routers at 2-4 rows included."""
    m, k, n = shape
    x, w = _int_operands(m, k, n, bits, cuda, seed=m + 3 * k + n)
    got = sc_matmul_cuda(x, w, n_planes=bits // 4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=bits // 4))


@pytest.mark.parametrize("name", LM_FAMILIES)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16", "sc_w8a8"])
def test_lm_families_smoke_serving_on_the_card(cuda, name, quant):
    """Smoke width: prefill of 2 x 12 (past the hybrid's window of 8) into caches of
    20, then 3 decode steps fed the card's greedy tokens, on the card and on the CPU
    from the same params: every SC call bitwise equal to the plain version, the
    counted launches a step as the family's linears say, the logits within
    LM_CPU_ATOL of the CPU's."""
    import copy

    from repro_torch.models.families import get_family_api
    from repro_torch.serve import make_serve_fns

    cfg = get_config(name, smoke=True)
    p_cpu = get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(0),
                                        device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    pol = ExecutionPolicy(quant=quant)
    fg, fc = make_serve_fns(cfg, pol, device=cuda), make_serve_fns(cfg, pol, device="cpu")
    batch = {"tokens": np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))}
    n_sc = _family_sc_calls(cfg) if quant != "none" else 0
    registry.reset_launches()
    (lg, sg), calls = _record_sc(lambda: fg["prefill"](p_gpu, batch, 20))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == len(calls) == n_sc
    lc, sc = fc["prefill"](p_cpu, batch, 20)
    diffs = [(lg.cpu() - lc).abs().max().item()]
    tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    for _ in range(3):
        registry.reset_launches()
        (lg, nxt, sg), more = _record_sc(lambda: fg["decode"](p_gpu, sg, {"token": tok}))
        torch.cuda.synchronize()
        assert registry.launches()["sc_matmul"] == len(more) == n_sc
        calls += more
        lc, _, sc = fc["decode"](p_cpu, sc, {"token": tok.cpu()})
        diffs.append((lg.cpu() - lc).abs().max().item())
        tok = nxt
    assert int(sg.cache_len) == 15
    for args, kw in calls:
        assert torch.equal(sc_matmul_cuda(*args, **kw), sc_matmul_plain(*args, **kw))
    assert max(diffs) <= LM_CPU_ATOL["float" if quant == "none" else "quantized"], diffs


@pytest.mark.parametrize("name", LM_FAMILIES)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_families_train_step_on_the_card_against_the_cpu(cuda, name, quant):
    """Smoke width, float32, remat full, 2 x 48 tokens: train_loss and every gradient
    leaf on the card against the CPU (LM_TRAIN_GRAD_REL; SC the nonzero pattern
    too), every SC call of the step bitwise equal to the plain version and as many
    as the remat rule gives; then one make_train_step step on each side."""
    import copy

    from repro_torch.models.families import get_family_api
    from repro_torch.optim import adamw_init
    from repro_torch.params import named_jax_params
    from repro_torch.train import make_train_step

    cfg = get_config(name, smoke=True)
    api = get_family_api(cfg)
    p_cpu = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    pol = ExecutionPolicy(quant=quant)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 48))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}

    def grads(params, b):
        named = named_jax_params(params)
        loss, _ = api["train_loss"](params, cfg, b, policy=pol)
        return loss.detach(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    on_card = {k: v.to(cuda) for k, v in batch.items()}
    registry.reset_launches()
    (loss_gpu, g_gpu), calls = _record_sc(lambda: grads(p_gpu, on_card))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == len(calls) == (
        _family_sc_calls(cfg, train=True) if quant != "none" else 0)
    for args, kw in calls:
        assert torch.equal(sc_matmul_cuda(*args, **kw), sc_matmul_plain(*args, **kw))
    loss_cpu, g_cpu = grads(p_cpu, batch)
    atol = LM_CPU_ATOL["float" if quant == "none" else "quantized"]
    assert abs(loss_gpu.item() - loss_cpu.item()) <= atol
    bad = []
    for k, want in g_cpu.items():
        got, want = g_gpu[k].cpu().double(), want.double()
        top = want.abs().max().item()
        if quant != "none" and not torch.equal(got.abs() > 1e-30, want.abs() > 1e-30):
            bad.append(f"{k}: nonzero pattern")
        if top > 1e-30 and (got - want).abs().max().item() > LM_TRAIN_GRAD_REL[quant] * top:
            bad.append(f"{k}: {(got - want).abs().max().item() / top:.3e} of its max")
    assert not bad, bad
    step_gpu = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1, policy=pol)
    step_cpu = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1, policy=pol)
    m_gpu = step_gpu(p_gpu, adamw_init(p_gpu), on_card)[2]
    m_cpu = step_cpu(p_cpu, adamw_init(p_cpu), batch)[2]
    assert m_gpu["loss"].is_cuda and abs(m_gpu["loss"].item() - m_cpu["loss"].item()) <= atol


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_families_moe_ties_route_alike_on_the_card(cuda, quant):
    """granite smoke's router with experts 1-3 tied on every token: the card's
    routing (expert rows, columns, kept pairs) equals the CPU's bitwise, the lower
    experts picked, its weights within 1e-6 (the softmax's order of operations
    differs), and the MoE's outputs agree within LM_CPU_ATOL."""
    import copy

    from repro_torch.models import moe as M

    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    m_cpu = M.MoE(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        m_cpu.router.w[:, 1:4] = 1.0
        m_cpu.router.w[:, 0] = 0.5
        m_cpu.router.w[:, 4:] = -1.0
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    x = torch.from_numpy(np.abs(np.random.default_rng(7).standard_normal((2, 12, cfg.d_model)))
                         .astype(np.float32))
    pol = ExecutionPolicy(quant=quant)
    with torch.no_grad():
        r_cpu = M.route(cfg, M.router_logits(m_cpu.router, x, pol))
        r_gpu = M.route(cfg, M.router_logits(m_gpu.router, x.to(cuda), pol))
        out_cpu = M.moe_apply(m_cpu, cfg, x, pol)
        out_gpu = M.moe_apply(m_gpu, cfg, x.to(cuda), pol)
    for i in (0, 1, 3):  # the expert rows, their columns and the kept pairs
        assert torch.equal(r_gpu[i].cpu(), r_cpu[i])
    assert (r_gpu[2].cpu() - r_cpu[2]).abs().max().item() <= 1e-6  # the softmax weights
    assert set(torch.where(r_cpu[3], r_cpu[0], -1).unique().tolist()) <= {-1, 1, 2}
    assert (out_gpu.cpu() - out_cpu).abs().max().item() <= LM_CPU_ATOL["float"]


# -- the encdec and vlm LM families -------------------------------------------------------

LM_ENCDEC_VLM = ["whisper-small", "internvl2-2b"]
# Card against the CPU, train step gradients, of each leaf's max: float as
# LM_TRAIN_GRAD_REL; SC 5e-2.  internvl2 smoke's block-0 MLP leaves (ln2.g,
# wi, wg, wo) sit on a quantizer boundary for this batch: one-ulp nudges of
# the CPU run's patch inputs alone move them by 1.29e-2 of their max, and the
# card measured 1.556e-2 (H100); phase 9 measured 4.1e-2 in float32 for the
# same scale-path reason.
ENCDEC_VLM_TRAIN_GRAD_REL = {"none": 1e-4, "sc_w16a16": 5e-2}


def _lm_encdec_vlm_shapes():
    """(M, K, N) of the SC matmul at whisper-small's and internvl2-2b's full widths:
    whisper's 768 -> 768 (attention, cross-attention), 768 -> 3072 and 3072 -> 768
    (MLP) at decode rows (4), the decoder's prefill rows (4 x 64), the encoder's
    (4 x 1536 frames) and training rows (8 x 256); internvl2's 2048 -> 2048 (wq, wo,
    patch_proj), 2048 -> 1024 (wk, wv), 2048 <-> 8192 (GLU) at decode rows (4),
    prefill rows (4 x (256 patches + 128 tokens)) and training rows (8 x 512)."""
    shapes = set()
    for m in (4, 256, 6144, 2048):
        shapes |= {(m, 768, 768), (m, 768, 3072), (m, 3072, 768)}
    for m in (4, 1536, 4096):
        shapes |= {(m, 2048, 2048), (m, 2048, 1024), (m, 2048, 8192), (m, 8192, 2048)}
    return sorted(shapes)


def _encdec_vlm_sc_calls(cfg, step: str) -> int:
    """SC matmuls of one whisper or internvl2 step ("prefill", "decode" or "train",
    remat full): encoder layers 6 (attention 4, MLP 2), decoder layers 10 (self 4,
    cross 4, MLP 2) or 8 in decode (the cross K/V cached); vlm layers 7 (attention
    4, GLU 3) and patch_proj in prefill and training, outside the remat."""
    if cfg.family == "encdec":
        per = {"prefill": 6 * cfg.encoder_layers + 10 * cfg.n_layers, "decode": 8 * cfg.n_layers}
        per["train"] = 2 * per["prefill"]
    else:
        per = {"prefill": 7 * cfg.n_layers + 1, "decode": 7 * cfg.n_layers,
               "train": 14 * cfg.n_layers + 1}
    return per[step]


def _encdec_vlm_inputs(cfg, b: int, seed: int) -> dict:
    """Seeded float32 stub frontend outputs: 20 encoder frames, or the patches."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal((b, 20, cfg.d_model)).astype(np.float32)}
    return {"patch_embeds": rng.standard_normal((b, cfg.n_patches, cfg.d_model))
            .astype(np.float32)}


@pytest.mark.parametrize("shape", _lm_encdec_vlm_shapes())
@pytest.mark.parametrize("bits", [16, 8])
def test_sc_matmul_kernel_at_lm_encdec_vlm_shapes(cuda, shape, bits):
    m, k, n = shape
    x, w = _int_operands(m, k, n, bits, cuda, seed=m + 5 * k + n)
    got = sc_matmul_cuda(x, w, n_planes=bits // 4)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_matmul_plain(x, w, n_planes=bits // 4))


@pytest.mark.parametrize("name", LM_ENCDEC_VLM)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16", "sc_w8a8"])
def test_lm_encdec_vlm_smoke_serving_on_the_card(cuda, name, quant):
    """Smoke width: prefill of 2 x 12 tokens (with 20 encoder frames or 8 patches)
    into caches of 20 text positions, then 3 decode steps fed the card's greedy
    tokens, on the card and on the CPU from the same params: every SC call bitwise
    equal to the plain version, the counted launches of a prefill and of a decode
    step as the family's linears say, the logits within LM_CPU_ATOL of the CPU's."""
    import copy

    from repro_torch.models.families import get_family_api
    from repro_torch.serve import make_serve_fns

    cfg = get_config(name, smoke=True)
    p_cpu = get_family_api(cfg)["init"](cfg, generator=torch.Generator().manual_seed(0),
                                        device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    pol = ExecutionPolicy(quant=quant)
    fg, fc = make_serve_fns(cfg, pol, device=cuda), make_serve_fns(cfg, pol, device="cpu")
    batch = {"tokens": np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)),
             **_encdec_vlm_inputs(cfg, 2, 5)}
    ahead = cfg.n_patches if cfg.family == "vlm" else 0
    sc = quant != "none"
    registry.reset_launches()
    (lg, sg), calls = _record_sc(lambda: fg["prefill"](p_gpu, batch, 20 + ahead))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == len(calls) == (
        _encdec_vlm_sc_calls(cfg, "prefill") if sc else 0)
    lc, st_c = fc["prefill"](p_cpu, batch, 20 + ahead)
    diffs = [(lg.cpu() - lc).abs().max().item()]
    tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    for _ in range(3):
        registry.reset_launches()
        (lg, nxt, sg), more = _record_sc(lambda: fg["decode"](p_gpu, sg, {"token": tok}))
        torch.cuda.synchronize()
        assert registry.launches()["sc_matmul"] == len(more) == (
            _encdec_vlm_sc_calls(cfg, "decode") if sc else 0)
        calls += more
        lc, _, st_c = fc["decode"](p_cpu, st_c, {"token": tok.cpu()})
        diffs.append((lg.cpu() - lc).abs().max().item())
        tok = nxt
    assert int(sg.cache_len) == ahead + 15
    for args, kw in calls:
        assert torch.equal(sc_matmul_cuda(*args, **kw), sc_matmul_plain(*args, **kw))
    assert max(diffs) <= LM_CPU_ATOL["float" if quant == "none" else "quantized"], diffs


@pytest.mark.parametrize("name", LM_ENCDEC_VLM)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_encdec_vlm_train_step_on_the_card_against_the_cpu(cuda, name, quant):
    """Smoke width, float32, remat full, 2 x 48 tokens (48 encoder frames or 8
    patches a sequence): train_loss and every gradient leaf on the card against the
    CPU (ENCDEC_VLM_TRAIN_GRAD_REL; SC the nonzero pattern too), every SC call of
    the step bitwise equal to the plain version and as many as the remat rule
    gives; then one make_train_step step on each side.  whisper's attention key
    biases, whose exact gradient is zero, are held within 1e-6 of the largest
    gradient instead (tests/_lm.py's ZERO_GRAD_REL says why)."""
    import copy

    from repro_torch.models.families import get_family_api
    from repro_torch.optim import adamw_init
    from repro_torch.params import named_jax_params
    from repro_torch.train import make_train_step

    cfg = get_config(name, smoke=True)
    api = get_family_api(cfg)
    p_cpu = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    pol = ExecutionPolicy(quant=quant)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32))
    extra = {"encdec": ("enc_embeds", 48), "vlm": ("patch_embeds", cfg.n_patches)}[cfg.family]
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
             extra[0]: torch.from_numpy(rng.standard_normal((2, extra[1], cfg.d_model))
                                        .astype(np.float32))}

    def grads(params, b):
        named = named_jax_params(params)
        loss, _ = api["train_loss"](params, cfg, b, policy=pol)
        return loss.detach(), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    on_card = {k: v.to(cuda) for k, v in batch.items()}
    registry.reset_launches()
    (loss_gpu, g_gpu), calls = _record_sc(lambda: grads(p_gpu, on_card))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == len(calls) == (
        _encdec_vlm_sc_calls(cfg, "train") if quant != "none" else 0)
    for args, kw in calls:
        assert torch.equal(sc_matmul_cuda(*args, **kw), sc_matmul_plain(*args, **kw))
    loss_cpu, g_cpu = grads(p_cpu, batch)
    atol = LM_CPU_ATOL["float" if quant == "none" else "quantized"]
    assert abs(loss_gpu.item() - loss_cpu.item()) <= atol
    largest = max(g.abs().max().item() for g in g_cpu.values())
    bad, worst = [], 0.0
    for k, want in g_cpu.items():
        got, want = g_gpu[k].cpu().double(), want.double()
        top = want.abs().max().item()
        if k.endswith("wk.b"):
            if max(top, got.abs().max().item()) > 1e-6 * largest:
                bad.append(f"{k}: key bias gradient above 1e-6 of the largest")
            continue
        if quant != "none" and not torch.equal(got.abs() > 1e-30, want.abs() > 1e-30):
            bad.append(f"{k}: nonzero pattern")
        rel = (got - want).abs().max().item() / max(top, 1e-30)
        worst = max(worst, rel) if top > 1e-30 else worst
        if top > 1e-30 and rel > ENCDEC_VLM_TRAIN_GRAD_REL[quant]:
            bad.append(f"{k}: {rel:.3e} of its max")
    print(f"{name} {quant}: worst gradient {worst:.3e} of its leaf's max")
    assert not bad, bad
    step_gpu = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1, policy=pol)
    step_cpu = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1, policy=pol)
    m_gpu = step_gpu(p_gpu, adamw_init(p_gpu), on_card)[2]
    m_cpu = step_cpu(p_cpu, adamw_init(p_cpu), batch)[2]
    assert m_gpu["loss"].is_cuda and abs(m_gpu["loss"].item() - m_cpu["loss"].item()) <= atol


@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_encdec_vlm_cross_attention_decode_step_replays(cuda, quant):
    """whisper smoke's decode step (self-attention against its cache, the
    cross-attention over the cached encoder K/V, the position row gathered at
    cache_len) captured as one CUDA graph, which fails on any read back to the
    host, then replayed on another token and state: bitwise equal to the eager
    step on those inputs, and the SC launches of a step credited to the replay."""
    from repro_torch.models.families import EncDecState, get_family_api
    from repro_torch.models.layers import KVCache
    from repro_torch.serve import make_serve_fns

    cfg = get_config("whisper-small", smoke=True)
    api = get_family_api(cfg)
    params = api["init"](cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    pol = ExecutionPolicy(quant=quant)
    fns = make_serve_fns(cfg, pol, device=cuda)
    rng = np.random.default_rng(9)

    def prefilled(seed):
        batch = {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 12)),
                 **_encdec_vlm_inputs(cfg, 2, seed)}
        logits, st = fns["prefill"](params, batch, 20)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None], st

    def step(tok, sk, sv, ck, cv, cl):
        st = EncDecState(KVCache(sk, sv), KVCache(ck, cv), cl)
        with torch.no_grad():
            logits, new = api["decode_step"](params, cfg, st, {"token": tok}, policy=pol)
        return logits, new.self_caches.k, new.self_caches.v, new.cache_len

    def flat(tok, st):
        return [tok, *st.self_caches, *st.cross_caches, st.cache_len]

    tok0, st0 = prefilled(1)
    static = [t.clone() for t in flat(tok0, st0)]
    step(*static)  # the eager warm-up at these shapes, on this thread
    torch.cuda.synchronize()
    graph, outputs, launches = graphs.capture_graph(step, static, "whisper decode step")
    assert launches.get("sc_matmul", 0) == (_encdec_vlm_sc_calls(cfg, "decode")
                                             if quant != "none" else 0)
    art = graphs.Artifact(graph, static, outputs, launches)
    tok1, st1 = prefilled(2)
    st1 = st1._replace(cache_len=st1.cache_len + int(rng.integers(1, 4)))
    registry.reset_launches()
    got = art.replay(flat(tok1, st1))
    torch.cuda.synchronize()
    assert registry.launches()["sc_matmul"] == launches.get("sc_matmul", 0)
    with graphs.eager():
        want = step(*flat(tok1, st1))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# -- the LM's device layout: the host mesh and the op counter ---------------------------------


def _lm_mesh_run(cfg, params, pol, tokens, batch):
    """A prefill of `tokens` into caches of 24, 3 greedy decode steps, and the loss
    and every gradient of `batch`: every tensor it gives, in order."""
    from repro_torch.models import transformer as T

    outs = []
    with torch.no_grad():
        logits, state = T.prefill(params, cfg, tokens, 24, policy=pol)
        outs += [logits, *[t for c in state.caches for t in c], state.cache_len]
        for _ in range(3):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            logits, state = T.decode_step(params, cfg, state, tok, policy=pol)
            outs += [logits, *[t for c in state.caches for t in c]]
    loss, grads = _lm_grads(cfg, params, batch, pol)
    return outs + [loss, *grads.values()]


@pytest.mark.parametrize("name", LM_DENSE)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_mesh_hints_change_nothing_on_the_card(cuda, name, quant):
    """Smoke width on the card: a prefill, 3 decode steps and a loss with every
    gradient under activation_sharding(make_host_mesh(), mode) for sp and fsdp2d,
    bitwise equal to the same calls outside any context; the SC launches equal."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.hints import activation_sharding

    cfg = get_config(name, smoke=True)
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(cuda)
    pol = ExecutionPolicy(quant=quant)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(cuda)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    registry.reset_launches()
    want = _lm_mesh_run(cfg, params, pol, tokens, batch)
    torch.cuda.synchronize()
    n_sc = registry.launches()["sc_matmul"]
    assert (n_sc > 0) == (quant != "none")
    mesh = make_host_mesh()
    assert mesh.devices == (torch.device("cuda", torch.cuda.current_device()),)
    for mode in ("sp", "fsdp2d"):
        registry.reset_launches()
        with activation_sharding(mesh, mode=mode):
            got = _lm_mesh_run(cfg, params, pol, tokens, batch)
        torch.cuda.synchronize()
        assert registry.launches()["sc_matmul"] == n_sc
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (mode, i)


@pytest.mark.parametrize("name", LM_DENSE)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_lm_mesh_counts_on_the_card_equal_meta(cuda, name, quant):
    """The op counter (launch/hlo_analysis) over a smoke prefill and a train step on
    the card and on meta tensors: ops, FLOPs, bytes and dot FLOPs equal; under SC
    each linear is one kernel call either way."""
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    cfg = get_config(name, smoke=True)
    pol = ExecutionPolicy(quant=quant)
    counts = {}
    for dev in (cuda, torch.device("meta")):
        gen = None if dev.type == "meta" else torch.Generator().manual_seed(0)
        params = T.init_lm(cfg, generator=gen, device="cpu" if gen else dev).to(dev)
        toks = torch.zeros((2, 32), dtype=torch.int32, device=dev)
        pre = analyze(lambda: T.prefill(params, cfg, toks, 32, policy=pol))
        step = make_train_step(cfg, policy=pol)
        opt = adamw_init(params)
        train = analyze(lambda: step(params, opt, {"tokens": toks, "labels": toks}))
        counts[dev.type] = [(r["ops"], r["flops"], r["bytes"], r["dot_flops"],
                             r["ops_by_kind"].get("sc_matmul", 0)) for r in (pre, train)]
    assert counts["cuda"] == counts["meta"], counts
    n_lin = (4 + (3 if cfg.mlp_kind == "glu" else 2)) * cfg.n_layers
    assert counts["cuda"][0][4] == (n_lin if quant != "none" else 0)
    assert counts["cuda"][1][4] == (2 * n_lin if quant != "none" else 0)



# -- the comparison corners through the runtime, and the examples ---------------------------

# Card against the CPU at smoke width, chip_smoke.py's TRAIN_GRAD_TOL with its
# reasons: float 5e-3 of each leaf's max (a max-pool tie the card's sums break
# the other way), SC 1e-3 where the leaf's max is at least 1e-3 and 1e-1 on the
# scale path below it, with the nonzero pattern above 1e-30 equal.
CORNER_GRAD_TOL = {"none": 5e-3, "sc_w16a16": 1e-3, "sc scale path": 1e-1}


def _corner_cfg(model, preproc, aggregation):
    return dataclasses.replace(get_config(model, smoke=True), preproc=preproc,
                               aggregation=aggregation)


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("preproc,aggregation", COMPARISON_CORNERS)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_corners_runtime_serving_on_the_card(cuda, model, preproc, aggregation, quant):
    """Eight ragged clouds queued before the runtime starts (two full batches):
    every response bitwise equal to an eager infer of its padded batch on the
    card, and nothing captured after the warmup."""
    from repro_torch.serve import (RuntimeConfig, ServingRuntime, TraceConfig,
                                   padded_batch_responses, served_batches)

    cfg = _corner_cfg(model, preproc, aggregation)
    policy = ExecutionPolicy(quant=quant)
    params = get_accelerator(cfg, policy, device=cuda).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(21)
    sizes = (cfg.n_points, cfg.n_points * 150 // 256, cfg.n_points * 5 // 4)
    clouds = [rng.standard_normal((sizes[i % 3], 3)).astype(np.float32) for i in range(8)]
    rt = ServingRuntime(cfg, params, RuntimeConfig(max_batch=4, max_wait_s=1.0,
                                                   buckets=(cfg.n_points,), trace=TraceConfig()),
                        policy=policy, device=cuda)
    try:
        rt.warmup()
        before = graphs.captures()
        futs = [rt.submit(c) for c in clouds]
        rt.start()
        outs = [f.result(timeout=120) for f in futs]
        _wait(lambda: sum(b.n_real for b in rt.metrics.batch_records) >= len(clouds), "records")
    finally:
        rt.stop()
    assert graphs.captures() == before
    batches = served_batches(rt.tracer.events())
    assert sorted(i for idx, _ in batches for i in idx) == list(range(len(clouds)))
    want = padded_batch_responses(cfg, params, clouds, [policy] * len(clouds), batches, 4)
    for i, w in want.items():
        np.testing.assert_array_equal(outs[i], w)


@pytest.mark.parametrize("model", ["pointnet2-cls", "pointnet2-seg"])
@pytest.mark.parametrize("preproc,aggregation", COMPARISON_CORNERS)
@pytest.mark.parametrize("quant", ["none", "sc_w16a16"])
def test_corners_runtime_training_on_the_card(cuda, model, preproc, aggregation, quant):
    """Step 1's loss and gradients on the card against the port's CPU run
    (CORNER_GRAD_TOL), then three graphed steps bitwise equal to eager ones
    under deterministic kernels, with one capture."""
    from repro_torch.launch.train import value_and_grad

    cfg = _corner_cfg(model, preproc, aggregation)
    pol = ExecutionPolicy(quant=quant)
    accel = get_accelerator(cfg, pol, device=cuda)
    batches = _train_batches(cfg, 3, cuda, seed=2)
    p = accel.init(torch.Generator().manual_seed(0))
    (loss, _), grads = value_and_grad(accel, p, *batches[0])
    accel_cpu = get_accelerator(cfg, pol, device="cpu")
    (loss_cpu, _), grads_cpu = value_and_grad(
        accel_cpu, accel_cpu.init(torch.Generator().manual_seed(0)),
        *(t.cpu() for t in batches[0]))
    assert abs(loss.item() - loss_cpu.item()) <= (1e-5 if quant == "none" else 1e-3)
    for name, w in grads_cpu.items():
        g, w = grads[name].cpu().double(), w.double()
        top = w.abs().max().item()
        if quant == "none":
            assert (g - w).abs().max().item() <= CORNER_GRAD_TOL["none"] * top, name
            continue
        assert torch.equal(g.abs() > 1e-30, w.abs() > 1e-30), name
        if top > 1e-30:
            tol = CORNER_GRAD_TOL["sc_w16a16" if top >= 1e-3 else "sc scale path"]
            assert (g - w).abs().max().item() <= tol * top, name
    with _deterministic():
        eager = _fresh_step(accel)
        with graphs.eager():
            want = [eager(*b) for b in batches]
        graphed = _fresh_step(accel)
        before = graphs.captures()
        got = [graphed(*b) for b in batches]
    assert graphs.captures() - before == 1
    for g, w in zip(got, want):
        for k in g:
            assert torch.equal(g[k], w[k]), k
    for a, b in zip(graphed._tensors(), eager._tensors()):
        assert torch.equal(a, b)


EXAMPLE_ARGS = {
    "quickstart": [],
    "train_pointcloud": ["--steps", "3", "--batch", "2", "--quant", "sc_w16a16"],
    "preprocess_pipeline": [],
    "serve_runtime": ["--requests", "12", "--mix-quant"],
    "serve_slo": ["--requests", "120"],
    "serve_trace": ["--requests", "16", "--rate", "400"],
}


@pytest.mark.parametrize("name", list(EXAMPLE_ARGS))
def test_examples_run_on_the_card(cuda, name, tmp_path, capsys):
    """Each point-cloud example's main() with --device cuda (its full config),
    counts cut: it launches the port's kernels and its own check passes; on
    the card torch_preprocess_pipeline holds its FPS and flat lattice calls
    against the plain versions."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = ["--device", "cuda", *EXAMPLE_ARGS[name]]
    if name == "train_pointcloud":
        args += ["--ckpt-dir", str(tmp_path)]
    if name == "serve_trace":
        args += ["--out", str(tmp_path / "trace.json")]
    registry.reset_launches()
    out = mod.main(args)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("check: ") and last.endswith(": ok"), last
    assert any(registry.launches().values())
    if name == "preprocess_pipeline":
        assert out["kernel_equals_plain"] == {"fps_tiles": True, "lattice_query": True}
    if name == "serve_trace":  # the replicas' replays, traced
        assert out["graph_replays"] > 0


# The benchmark's closed-loop cells (BENCHMARK.json): model, clouds a batch, quant.
GRAPH_SPAN_CELLS = {
    "seg-sc-b16": ("pointnet2-seg", 16, "sc_w16a16"),
    "cls-sc-b64": ("pointnet2-cls", 64, "sc_w16a16"),
    "cls-fp32-b64": ("pointnet2-cls", 64, "none"),
}
GRAPH_SPAN_REPLAYS = 48
LAUNCH_SLACK_S = 20e-6


@pytest.mark.parametrize("cell", list(GRAPH_SPAN_CELLS))
def test_traced_replays_share_the_profilers_clock_and_time_the_cards_stages(cuda, cell):
    """A traced closed loop of `infer` at a benchmark cell's shape, each batch's
    logits read back, part of it under torch.profiler: with the profiler's clock
    mapped onto time.monotonic, at least 99 % of the cudaGraphLaunch host records
    lie within 20 us of a replay's launch span; the card's preprocess + feature
    time a replay, from the graph's own timing events in the replays after the
    profiled stretch, comes within 10 % of the card's busy time a replay in the
    stretch from the records of the graph's launches (the copy in, the clone and
    the read-back left out); and no replay's stage times were missed.

    The map: a range recorded between two monotonic stamps ends before the
    second, so each gives a least offset; entering a range takes tens of
    microseconds before its start is stamped and leaving it a few after its end,
    so the greatest of these bounds over a dozen ranges is the offset to a few
    microseconds.  The stage times are read outside the profiler: under it the
    card idles some 0.3 ms at the start of each replay, which the graph's marks
    see and its kernel records do not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.accelerator import PC2IMAccelerator
    from repro_torch.serve.trace import TraceConfig, Tracer

    model, batch, quant = GRAPH_SPAN_CELLS[cell]
    cfg = get_config(model)
    accel = PC2IMAccelerator(cfg, ExecutionPolicy(quant=quant), cuda)  # captures anew
    params = accel.init(torch.Generator().manual_seed(0))
    pool = [np.random.default_rng(s).uniform(-1, 1, (batch, cfg.n_points, 3))
            .astype(np.float32) for s in range(4)]
    tracer = Tracer(TraceConfig(capacity=1 << 16))
    with graphs.traced(tracer):
        for i in range(4):  # the capture, with its timing marks, and warm replays
            accel.infer(params, pool[i]).cpu()
        missed = graphs.stage_times_missed()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(64):  # a session can lose its first device records
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            accel.infer(params, pool[0]).cpu()
            stamps = []
            for _ in range(6):
                with record_function("graph-span-clock"):
                    pass
                stamps.append(time.monotonic())
            mono0 = time.monotonic()
            with record_function("graph-span-stretch"):
                for i in range(GRAPH_SPAN_REPLAYS):
                    accel.infer(params, pool[i % 4]).cpu()
            mono1 = time.monotonic()
            for _ in range(6):
                with record_function("graph-span-clock"):
                    pass
                stamps.append(time.monotonic())
        for i in range(GRAPH_SPAN_REPLAYS + 1):  # unprofiled; the first reads the last
            accel.infer(params, pool[i % 4]).cpu()  # profiled replay's stage times
    assert graphs.stage_times_missed() == missed
    assert tracer.dropped == 0
    launches, device, stretch, clock = {}, [], None, []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            device.append((evt.start_ns(), evt.end_ns(), evt.correlation_id()))
        elif evt.name() == "graph-span-stretch":
            stretch = (evt.start_ns(), evt.end_ns())
        elif evt.name() == "graph-span-clock":
            clock.append(evt.end_ns())
        elif evt.name() == "cudaGraphLaunch":
            launches[evt.correlation_id()] = (evt.start_ns(), evt.end_ns())
    assert stretch is not None and len(clock) == len(stamps)
    s0, s1 = stretch
    offset = max(end - t * 1e9 for end, t in zip(sorted(clock), stamps))
    ends = [e for e in tracer.events() if e.name == "graph.replay_end"]
    spans = [(e.args["copied"] - LAUNCH_SLACK_S, e.args["launched"] + LAUNCH_SLACK_S)
             for e in ends if mono0 <= e.args["start"] <= mono1]
    assert len(spans) == GRAPH_SPAN_REPLAYS
    inside = {c: ((a - offset) / 1e9, (b - offset) / 1e9) for c, (a, b) in launches.items()
              if s0 <= a <= s1}
    assert len(inside) == GRAPH_SPAN_REPLAYS
    held = sum(any(t0 <= a and b <= t1 for t0, t1 in spans) for a, b in inside.values())
    assert held >= 0.99 * len(inside), (held, len(inside))
    busy, edge = 0, s0
    for a, b in sorted((a, b) for a, b, c in device if c in inside):
        busy += max(0, b - max(a, edge))
        edge = max(edge, b)
    busy_ms = busy / 1e6 / GRAPH_SPAN_REPLAYS
    stages = [e.args for e in tracer.events()
              if e.name == "graph.stage_times" and e.args["replay_t"] > mono1]
    assert len(stages) == GRAPH_SPAN_REPLAYS
    assert all(a["preprocess_ms"] > 0 and a["feature_ms"] > 0 for a in stages)
    stage_ms = float(np.median([a["preprocess_ms"] + a["feature_ms"] for a in stages]))
    assert abs(stage_ms - busy_ms) <= 0.1 * busy_ms, (stage_ms, busy_ms)
