"""Port parity, the accelerator's serving entry points: the result-tree helpers,
`feature_from_cached`, `infer_with_preprocess`, the pipelined executor and
`two_stage_schedule`, on the CPU (the kernels' plain versions).

Tolerances: none.  Every entry point here runs the composition `infer`
runs, so its logits are held bitwise against `infer`; the result trees
hold integer indices, masks and float32 coordinates, held bitwise against
the JAX package's preprocessing of the same clouds.
"""

import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.pointnet2_cls import smoke_config as j_cls_smoke
from repro.core.accelerator import get_accelerator as j_get_accelerator
from repro.core.engine import result_row as j_result_row
from repro.core.engine import serialize_result as j_serialize_result
from repro.core.policy import ExecutionPolicy as JPolicy
from repro_torch.configs import get_config
from repro_torch.core import accelerator as TA
from repro_torch.core.engine import (
    deserialize_result,
    result_leaves,
    result_map,
    result_nbytes,
    result_row,
    result_set_row,
    result_stack,
    result_to,
    result_to_host,
    serialize_result,
)
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.preprocess import PreprocessResult
from repro_torch.parallel.pipeline import two_stage_schedule

jax.config.update("jax_platform_name", "cpu")

WAIT_S = 60
QUANTS = ("none", "sc_w16a16")
MODELS = ("pointnet2-cls", "pointnet2-seg")


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (4, 256, 3)).astype(np.float32)
    pts[1] = np.round(pts[1] * 4) / 4  # a tie-heavy cloud
    return pts


@pytest.fixture(scope="module")
def params():
    """Seeded port params of each smoke config, on the CPU."""
    return {
        m: TA.get_accelerator(get_config(m, smoke=True), device="cpu").init(
            torch.Generator().manual_seed(0))
        for m in MODELS
    }


def _accel(model, quant="none"):
    return TA.get_accelerator(get_config(model, smoke=True), ExecutionPolicy(quant=quant),
                              device="cpu")


def _assert_trees_equal(a, b):
    la, lb = result_leaves(a), result_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# -- result-tree helpers -------------------------------------------------------


@pytest.fixture(scope="module")
def pre(clouds):
    """The port's cls preprocessing of `clouds`: one PreprocessResult per SA stage."""
    return _accel("pointnet2-cls").preprocess_stage(clouds)


def test_result_leaves_follow_field_order(pre):
    leaves = result_leaves(pre)
    assert len(leaves) == 5 * len(pre)  # idx, xyz, neighbors.idx, neighbors.mask, valid
    first = pre[0]
    assert leaves[:5] == [first.centroid_idx, first.centroid_xyz, first.neighbors.idx,
                          first.neighbors.mask, first.centroid_valid]


def test_result_map_keeps_namedtuple_types(pre):
    out = result_map(lambda x: x + 0 if x.dtype != torch.bool else x, pre)
    assert type(out) is tuple and all(type(r) is PreprocessResult for r in out)
    assert type(out[0].neighbors) is type(pre[0].neighbors)
    with pytest.raises(ValueError, match="structure"):
        result_map(lambda a, b: a, pre, pre[0])


def test_nbytes_counts_every_leaf(pre):
    want = sum(x.numel() * x.element_size() for x in result_leaves(pre))
    assert result_nbytes(pre) == want
    assert result_nbytes(result_to_host(pre)) == want


def test_to_host_is_a_writable_copy(pre):
    host = result_to_host(pre)
    for leaf, src in zip(result_leaves(host), result_leaves(pre)):
        assert isinstance(leaf, np.ndarray) and leaf.flags.writeable
        leaf[...] = 0
        assert not np.shares_memory(leaf, src.numpy())
    assert result_leaves(pre)[1].abs().sum() > 0  # the tensors were not written


def test_row_stack_roundtrip(pre):
    host = result_to_host(pre)
    rows = [result_row(host, i) for i in range(4)]
    _assert_trees_equal(result_stack(rows), host)
    rows_t = [result_row(pre, i) for i in range(4)]
    _assert_trees_equal(result_stack(rows_t), pre)


def test_stack_pads_zero_filler_rows(pre):
    host = result_to_host(pre)
    stacked = result_stack([result_row(host, 0), result_row(host, 1)], total=4)
    for leaf, src in zip(result_leaves(stacked), result_leaves(host)):
        assert leaf.shape == src.shape
        np.testing.assert_array_equal(leaf[:2], src[:2])
        assert not leaf[2:].any()
    with pytest.raises(ValueError, match="at least one row"):
        result_stack([])


def test_set_row_splices_in_place(pre):
    host = result_to_host(pre)
    donor = result_to_host(result_row(pre, 3))
    result_set_row(host, 0, donor)
    _assert_trees_equal(result_row(host, 0), donor)
    _assert_trees_equal(result_row(host, 1), result_row(pre, 1))


def test_serialize_roundtrip_bitwise(pre):
    back = deserialize_result(serialize_result(pre), pre)
    _assert_trees_equal(back, pre)
    assert type(back[0]) is PreprocessResult


def test_result_to_places_numpy_and_tensors(pre):
    host = result_to_host(pre)
    back = result_to(host, torch.device("cpu"))
    _assert_trees_equal(back, pre)
    assert all(isinstance(x, torch.Tensor) for x in result_leaves(back))


def test_serialized_leaves_equal_the_jax_package(clouds, pre):
    """The same clouds through both packages' preprocessing serialize to the
    same npz leaves: same count, order, dtypes, shapes and bits."""
    jpre = j_get_accelerator(j_cls_smoke(), JPolicy(backend="xla")).preprocess_stage(
        jnp.asarray(clouds))
    for port_res, jax_res in ((pre, jpre), (result_row(pre, 2), j_result_row(jpre, 2))):
        with np.load(io.BytesIO(serialize_result(port_res))) as a, \
                np.load(io.BytesIO(j_serialize_result(jax_res))) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k])


# -- accelerator entry points --------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("quant", QUANTS)
def test_feature_from_cached_equals_infer(clouds, params, model, quant):
    """Cache rows restacked on the host (numpy) feed the feature stage to the
    same logits as infer."""
    accel = _accel(model, quant)
    host = result_to_host(accel.preprocess_stage(clouds))
    rows = [result_row(host, i) for i in range(len(clouds))]
    got = accel.feature_from_cached(params[model], clouds, result_stack(rows))
    assert torch.equal(got, accel.infer(params[model], clouds))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("quant", QUANTS)
def test_infer_with_preprocess_equals_infer_and_preprocess_stage(clouds, params, model, quant):
    accel = _accel(model, quant)
    logits, pre = accel.infer_with_preprocess(params[model], clouds)
    assert torch.equal(logits, accel.infer(params[model], clouds))
    _assert_trees_equal(pre, accel.preprocess_stage(clouds))


# -- the pipelined executor ----------------------------------------------------


def _micro_batches(n=4, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (b, 256, 3)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("quant", QUANTS)
def test_infer_pipelined_equals_sequential_infer(params, model, quant):
    accel = _accel(model, quant)
    batches = _micro_batches()
    got = accel.infer_pipelined(params[model], batches)
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert torch.equal(g, accel.infer(params[model], b))


def test_infer_pipelined_caches_one_executor_per_key(params):
    accel = _accel("pointnet2-cls")
    batches = _micro_batches(n=2)
    accel.infer_pipelined(params["pointnet2-cls"], batches)
    accel.infer_pipelined(params["pointnet2-cls"], batches)
    accel.infer_pipelined(params["pointnet2-cls"], batches, depth=3)
    keys = [k for k in accel._executors if k[0] is None]
    assert sorted(k[1] for k in keys) == [2, 3]


def test_executor_over_two_named_devices(params):
    """Two devices named (both the CPU here): the two-device code path, same logits."""
    accel = _accel("pointnet2-cls")
    ex = TA.PipelinedExecutor(accel, devices=["cpu", "cpu"], depth=1)
    batches = _micro_batches(n=3)
    for g, b in zip(ex.run(params["pointnet2-cls"], batches), batches):
        assert torch.equal(g, accel.infer(params["pointnet2-cls"], b))


def test_executor_empty_stream(params):
    accel = _accel("pointnet2-cls")
    assert TA.PipelinedExecutor(accel).run(params["pointnet2-cls"], []) == []


def test_executor_refuses_an_empty_device_list():
    with pytest.raises(ValueError, match="devices"):
        TA.PipelinedExecutor(_accel("pointnet2-cls"), devices=[])


def test_params_copy_leaves_the_callers_module_alone(params):
    mine = params["pointnet2-cls"]
    before = [p.clone() for p in mine.parameters()]
    copy = TA.params_copy_on(mine, torch.device("cpu"))
    assert copy is not mine
    with torch.no_grad():
        for p in copy.parameters():
            p.add_(1.0)
    for p, q in zip(mine.parameters(), before):
        assert torch.equal(p, q)
    assert TA.params_device(mine) == torch.device("cpu")


# -- two_stage_schedule --------------------------------------------------------


def test_schedule_order_and_composition():
    out = two_stage_schedule(lambda x: x * 2, lambda y: y + 1, range(10), depth=2)
    assert out == [2 * i + 1 for i in range(10)]


def test_schedule_runs_stage_a_off_the_callers_thread():
    threads = []
    out = two_stage_schedule(lambda x: threads.append(threading.current_thread()) or x,
                             lambda y: y, [1, 2, 3])
    assert out == [1, 2, 3]
    assert all(t is not threading.current_thread() for t in threads)


def test_schedule_stage_a_exception_propagates():
    def a(x):
        if x == 3:
            raise KeyError("stage a")
        return x

    with pytest.raises(KeyError, match="stage a"):
        two_stage_schedule(a, lambda y: y, range(8))


def test_schedule_stage_b_exception_propagates_and_drains_the_producer():
    produced = []

    def a(x):
        produced.append(x)
        return x

    def b(y):
        if y == 1:
            raise ValueError("stage b")
        return y

    with pytest.raises(ValueError, match="stage b"):
        two_stage_schedule(a, b, range(50), depth=1)
    assert len(produced) < 50  # the producer stopped early


def test_schedule_empty():
    assert two_stage_schedule(lambda x: x, lambda y: y, []) == []
