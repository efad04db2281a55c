"""The port's gather + masked max-pool op (`kernels/group_pool`) on the CPU.

Its plain version against the composition it replaces on the main path,
`masked_maxpool(group_features(...))`, bitwise (all-masked centroids, a NaN
row, ties, any C and S); the gradient of the autograd Function against
autograd through that composition, bitwise; registration, dispatch and the
wrapper's refusals.  The kernel itself runs only on a card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import math

import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core import grouping as G
from repro_torch.core.query import NeighborSet
from repro_torch.kernels import build, registry
from repro_torch.kernels.group_pool.kernel import group_maxpool_cuda
from repro_torch.kernels.group_pool.ops import GroupMaxPool, group_maxpool
from repro_torch.kernels.group_pool.ref import group_maxpool_plain


def _inputs(b, n, c, m, s, seed=0, ties=True):
    """Features (ties: values on a 0.5 grid, no -0), int32 indices and a mask with
    an all-masked centroid, a centroid with every slot valid, and a NaN."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(b, n, c, generator=g)
    if ties:
        f = torch.round(f * 2) / 2 + 0.0
    idx = torch.randint(0, n, (b, m, s), generator=g, dtype=torch.int32)
    mask = torch.rand(b, m, s, generator=g) > 0.35
    mask[0, 0] = False
    mask[-1, -1] = True
    f[0, idx[0, 1, 0], c // 2] = float("nan")
    mask[0, 1, 0] = True
    return f, idx, mask


def _composition(f, idx, mask):
    return G.masked_maxpool(G.group_features(f, NeighborSet(idx, mask)), mask)


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_group_maxpool_is_registered_with_its_plain_version():
    spec = registry.get("group_maxpool")
    assert spec.plain is group_maxpool_plain and spec.cuda is group_maxpool_cuda
    x = torch.zeros(2, 4, 3)
    for backend in (None, "auto", "pallas", "xla"):
        assert registry.dispatch("group_maxpool", x, backend) is group_maxpool_plain
    assert "group_pool" in build.SOURCES
    assert (build.SRC_DIR / "group_pool.cu").is_file()


@pytest.mark.parametrize("c", [1, 3, 128, 256])
@pytest.mark.parametrize("s", [1, 16, 32])
def test_plain_version_equals_the_composition(c, s):
    f, idx, mask = _inputs(2, 40, c, 9, s, seed=c * 100 + s)
    want = _composition(f, idx, mask)
    assert _bitwise(group_maxpool_plain(f, idx, mask), want)
    assert _bitwise(group_maxpool(f, idx, mask), want)
    assert torch.equal(want[0, 0], torch.zeros(c))  # no valid slot: 0
    assert torch.isnan(want[0, 1, c // 2])


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_op_flattens_the_leading_dims(lead):
    f, idx, mask = _inputs(math.prod(lead), 12, 5, 6, 8, seed=len(lead))
    f, idx, mask = f.reshape(*lead, 12, 5), idx.reshape(*lead, 6, 8), mask.reshape(*lead, 6, 8)
    got = group_maxpool(f, idx, mask)
    assert got.shape == (*lead, 6, 5)
    assert _bitwise(got, _composition(f, idx, mask))


def test_values_below_the_sentinel():
    """A row with every slot valid takes the max of its values alone (below
    -1e30 too); a row with a padded slot takes the -1e30 sentinel as the
    composition does."""
    f = torch.full((1, 4, 2), -1e38)
    f[0, :, 1] = -float("inf")
    idx = torch.tensor([[[0, 1, 2], [3, 0, 0]]], dtype=torch.int32)
    mask = torch.tensor([[[True, True, True], [True, False, False]]])
    got = group_maxpool(f, idx, mask)
    assert _bitwise(got, _composition(f, idx, mask))
    assert got[0, 0, 0] == -1e38 and got[0, 0, 1] == -float("inf")
    assert got[0, 1, 0] == torch.tensor(-1e30)


def test_aggregate_delayed_equals_mlp_then_the_composition():
    f, idx, mask = _inputs(2, 30, 6, 7, 16, seed=3, ties=False)
    w = torch.randn(6, 10, generator=torch.Generator().manual_seed(4))
    mlp = lambda x: torch.relu(x @ w)  # noqa: E731
    nbrs = NeighborSet(idx, mask)
    got = G.aggregate_delayed(f, nbrs, mlp)
    assert _bitwise(got, _composition(mlp(f), idx, mask))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("c,s", [(3, 8), (128, 32)])
def test_gradient_equals_autograd_through_the_composition(ties, c, s):
    """amax's even split among tied slots and the gather's scatter-add, bitwise;
    a NaN would make the gradient NaN on both sides, so none is planted here."""
    g = torch.Generator().manual_seed(c + s + ties)
    f = torch.randn(2, 24, c, generator=g)
    if ties:
        f = torch.round(f) + 0.0  # many equal maxima
    idx = torch.randint(0, 24, (2, 6, s), generator=g, dtype=torch.int32)
    idx[:, :, 1] = idx[:, :, 0]  # a row read twice by one centroid
    mask = torch.rand(2, 6, s, generator=g) > 0.3
    mask[0, 0] = False
    up = torch.randn(2, 6, c, generator=g)
    a = f.clone().requires_grad_()
    b = f.clone().requires_grad_()
    out_a = group_maxpool(a, idx, mask)
    assert out_a.grad_fn is not None and "GroupMaxPool" in type(out_a.grad_fn).__name__
    (ga,) = torch.autograd.grad(out_a, a, up)
    (gb,) = torch.autograd.grad(_composition(b, idx, mask), b, up)
    assert _bitwise(ga, gb)
    assert ga.abs().sum() > 0


def test_function_backward_ignores_the_forward_impl():
    """The backward recomputes the plain composition, whatever ran forward."""
    f, idx, mask = _inputs(1, 10, 4, 3, 5, seed=7, ties=False)
    f = torch.nan_to_num(f).requires_grad_()
    calls = []

    def impl(*args):
        calls.append(args)
        return group_maxpool_plain(*args)

    out = GroupMaxPool.apply(impl, f, idx, mask)
    (g,) = torch.autograd.grad(out.sum(), f)
    (want,) = torch.autograd.grad(_composition(f, idx, mask).sum(), f)
    assert len(calls) == 1 and _bitwise(g, want)


def test_no_graph_without_grad():
    f, idx, mask = _inputs(1, 10, 4, 3, 5, seed=8)
    with torch.no_grad():
        assert group_maxpool(f.requires_grad_(), idx, mask).grad_fn is None
    with torch.inference_mode():
        assert group_maxpool(f.detach(), idx, mask).grad_fn is None


def test_plain_version_counts_no_launch():
    registry.reset_launches()
    group_maxpool(*_inputs(1, 10, 4, 3, 5))
    assert registry.launches()["group_maxpool"] == 0


def test_wrapper_and_op_refuse_what_they_do_not_take():
    f, idx, mask = _inputs(1, 10, 4, 3, 5)
    with pytest.raises(ValueError, match="CUDA"):
        group_maxpool_cuda(f, idx, mask)
    with pytest.raises(ValueError, match="CUDA"):
        group_maxpool_cuda(f.double(), idx.long(), mask)
    with pytest.raises(ValueError):
        group_maxpool(f, idx, mask[..., :4])
    with pytest.raises(ValueError):
        group_maxpool(f[0], idx, mask)
    with pytest.raises(ValueError):
        group_maxpool(torch.zeros(2, 10, 4), idx, mask)
    with pytest.raises(ValueError):
        group_maxpool(f.to("meta"), idx.to("meta"), mask.to("meta"))
