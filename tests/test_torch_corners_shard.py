"""Port parity, the five comparison corners sharded on the CPU: for the
pointnet2-cls and -seg smoke configs in baseline1/standard, baseline2/standard,
pc2im/standard, baseline1/delayed and baseline2/delayed, float and SC W16A16,

  * `mesh_artifacts(("cpu",) * 2).infer` under sharding="batch" and
    "tensor" against the port's single-device `infer` of the same batch;
  * a `ServingRuntime` over `["cpu"] * 4` with `devices_per_replica=2` (two
    replicas of two shards) serving batch-sharded and tensor-sharded
    requests side by side, each response against the single-device `infer`
    of the padded batch it rode in.

Every comparison is bitwise, the sharded artifacts' contract (batch mode
runs each row's math unchanged, with the SC activation scale made global by
an exact max; tensor mode quantizes the full weight and slices its integer
columns, and a column or row block of torch's CPU matmul equals that block
of the full product).  The gemv caveat of tests/test_torch_shard_parity.py
starts at eight shards; these groups have two.  The single-device `infer`
is held against the JAX forward in every corner by
tests/test_torch_baselines.py.
"""

import numpy as np
import pytest
import torch

from _port import (
    CORNER_IDS,
    CORNERS,
    MAX_BATCH,
    MODELS,
    QUANTS,
    WAIT_S,
    assert_served_bitwise,
    corner_configs,
    port_params,
    ragged_clouds,
    wait_records,
)
from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.serve import RuntimeConfig, ServingRuntime, TraceConfig, trace_problems

GROUP = ("cpu",) * 2
DEVICES = ["cpu"] * 4


@pytest.fixture(scope="module")
def params():
    """The reference's smoke params of each model, bridged once."""
    return {m: port_params(m) for m in MODELS}


def _batch(cfg, seed: int) -> np.ndarray:
    """MAX_BATCH clouds of the config's n_points, one of them grid-snapped (ties)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (MAX_BATCH, cfg.n_points, 3)).astype(np.float32)
    pts[1] = np.round(pts[1] * 4) / 4
    return pts


@pytest.mark.parametrize("mode", ["batch", "tensor"])
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("preproc,aggregation", CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("model", list(MODELS))
def test_mesh_artifacts_equal_single_device_infer(params, model, preproc, aggregation, quant,
                                                  mode):
    _, cfg = corner_configs(model, preproc, aggregation)
    pts = _batch(cfg, seed=5)
    want = get_accelerator(cfg, ExecutionPolicy(quant=quant), device="cpu").infer(
        params[model], pts)
    arts = get_accelerator(cfg, ExecutionPolicy(quant=quant, sharding=mode),
                           device="cpu").mesh_artifacts(GROUP)
    got = arts.infer(params[model], pts)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("preproc,aggregation", CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_runtime_responses_equal_infer(params, model, preproc, aggregation):
    """Two full batches of batch-sharded float and two of tensor-sharded SC
    requests, queued before start, on two replicas of two CPU shards."""
    _, cfg = corner_configs(model, preproc, aggregation)
    batch_f = ExecutionPolicy(sharding="batch")
    tensor_sc = ExecutionPolicy(quant="sc_w16a16", sharding="tensor")
    clouds = ragged_clouds(4 * MAX_BATCH, seed=6)
    policies = [batch_f] * (2 * MAX_BATCH) + [tensor_sc] * (2 * MAX_BATCH)
    rt = ServingRuntime(cfg, params[model], RuntimeConfig(
        max_batch=MAX_BATCH, max_wait_s=1.0, buckets=(cfg.n_points,), devices_per_replica=2,
        trace=TraceConfig()), devices=DEVICES)
    try:
        assert len(rt.pool.replicas) == 2
        rt.warmup((batch_f, tensor_sc))
        futs = [rt.submit(c, policy=p) for c, p in zip(clouds, policies)]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        wait_records(rt, len(clouds))
    finally:
        rt.stop()
    snap = rt.metrics.snapshot()
    assert snap.completed == len(clouds) and snap.failed == 0 and snap.retries == 0
    assert {b.policy_key[3] for b in rt.metrics.batch_records if b.n_real} == {"batch", "tensor"}
    assert trace_problems(rt.tracer.events()) == []
    assert assert_served_bitwise(cfg, params[model], rt, clouds, outs, policies) == 4
