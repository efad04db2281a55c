"""The dry run's census (`launch/spmd.py`): one device's collectives and memory of
a partitioned LM cell, from its step run over DTensors on meta shards.

(a) The reference's numbers.  A child with 8 forced host devices compiles the
reference's `build_cell` for the stablelm smoke overrides (SMOKE_SET) on a
(2, 4) ("data", "model") mesh and reads its `hlo_analysis`; the port's
census of the same cells on the same mesh is held against them.

dp_only (parameters replicated, the batch over "data") is held byte for byte,
each byte of difference traced:

  * train_4k: the reference all-reduces 623,888 B in 11 ops, the port
    213,636 B in 22.  The port reduces each of the 21 gradients once, in its
    parameter's dtype, bf16: 106,816 elements x 2 B = 213,632 B, and the
    loss's masked NLL sum once, f32: 4 B.  The reference reduces them in f32
    (its converts come before the all-reduce): + 213,632 B.  It reduces the
    LM head's gradient, f32[256, 64], inside the chunked cross entropy's
    loop, once a chunk: 4 chunks of 1024, 3 x 65,536 = + 196,608 B more than
    once; and its f32[] loss sum once a chunk: 4 x 4 - 4 = + 12 B.
    213,636 + 213,632 + 196,608 + 12 = 623,888.
  * prefill_32k: nothing, in both.
  * decode_32k: both all-reduce 6 times, 3 a layer, over the cache's
    sequence, which the decode-state rules split over "model" (2 kv heads
    do not divide 4): the softmax's max and sum, f32[64, 2, 2, 1] = 1,024 B
    each, and the attention output's partial sums, 64 x 4 heads x 16: the
    reference's in f32 (4,096 elements, 16,384 B), the port's in bf16
    (8,192 B), since the port casts the output to the cache's dtype before
    its partial sums are reduced.  36,864 - 2 x 8,192 = 20,480.

fsdp_tp and tp_only are held by the ratio of `collective_bytes_total` (port
/ reference) per shape, within 10 % of the ratio first measured (RATIOS);
PERF.md says op by op where the two partitioners part.

(b) A cell with its flash loops shortened (`core.accounting.loop`, one pair
for all on meta) and with every pair run gives the same census and the same
peak.

(c) `to_placements`: rank 0's shard under the placements is
`NamedSharding.shard_shape` (GSPMD's padded block) for every spec that
`param_pspecs` gives the ten archs on both production meshes.

(d) No process group is left initialised after `run_cell`, ok or failed.
"""

import threading

import pytest
import torch

from _multidev import run_in_child
from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config
from repro_torch.core import accounting
from repro_torch.launch import dryrun, spmd
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.params import lm_param_tree
from repro_torch.sharding import policy as POL
from repro_torch.sharding.spec import NamedSharding, PartitionSpec

SMOKE_SET = {"n_layers": "2", "d_model": "64", "n_heads": "4", "n_kv_heads": "2",
             "d_ff": "128", "vocab_size": "256"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
POLICIES = ("dp_only", "tp_only", "fsdp_tp")

# dp_only, all-reduce bytes: (reference, port), traced in the module docstring
DP_ONLY = {"train_4k": (623_888, 213_636), "prefill_32k": (0, 0),
           "decode_32k": (36_864, 20_480)}
# collective_bytes_total, port / reference, as first measured (held within 10 %)
RATIOS = {("tp_only", "train_4k"): 4.1044, ("tp_only", "prefill_32k"): 26.6879,
          ("tp_only", "decode_32k"): 0.3912, ("fsdp_tp", "train_4k"): 3.9530,
          ("fsdp_tp", "prefill_32k"): 26.6874, ("fsdp_tp", "decode_32k"): 0.5933}
RATIO_BAND = 0.10

_REF = """
import jax
jax.devices()
import numpy as np
from jax.sharding import Mesh
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import analyze
from repro.sharding.hints import activation_sharding

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
for pol in %r:
    for shape in %r:
        with mesh, activation_sharding(mesh, mode="off"):
            fn, args, cfg = D.build_cell("stablelm-1.6b", shape, mesh, pol, %r)
            h = analyze(fn.lower(*args).compile().as_text())
        emit(f"{pol}/{shape}/total", h["collective_bytes_total"])
        for kind, v in h["collectives"].items():
            emit(f"{pol}/{shape}/{kind}", [v["count"], v["bytes"]])
""" % (POLICIES, SHAPES, SMOKE_SET)


def _cfg(overrides=SMOKE_SET):
    return dryrun.apply_overrides(get_config("stablelm-1.6b"), overrides)


def _census(cfg, shape, mesh, policy):
    kind = SH.SHAPES[shape]["kind"]
    state = SH.decode_state_specs(cfg, shape) if kind == "decode" else None
    return spmd.census(cfg, kind, SH.input_specs(cfg, shape), state, mesh, policy)


def test_census_against_the_reference_on_eight_devices():
    ref, errors = {}, []

    def child():
        try:
            ref.update(run_in_child(_REF, n_devices=8, timeout_s=300))
        except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
            errors.append(e)

    t = threading.Thread(target=child)
    t.start()  # the reference compiles in its child while the port counts here
    mesh = Mesh((2, 4), ("data", "model"))
    cfg = _cfg()
    port = {(p, s): _census(cfg, s, mesh, p) for p in POLICIES for s in SHAPES}
    t.join()
    if errors:
        raise errors[0]
    for shape, (want_ref, want_port) in DP_ONLY.items():
        got = port["dp_only", shape]
        assert float(ref[f"dp_only/{shape}/total"]) == want_ref
        assert got["collective_bytes_total"] == want_port
        kinds = {k for k, v in got["collectives"].items() if v["count"]}
        assert kinds <= {"all-reduce"}
        if want_ref:
            assert {k.split("/")[2] for k in ref if k.startswith(f"dp_only/{shape}/")} == {
                "total", "all-reduce"}
            assert got["collectives"]["all-reduce"]["count"] == (22 if shape == "train_4k"
                                                                 else 6)
    ratios = {(p, s): port[p, s]["collective_bytes_total"] / float(ref[f"{p}/{s}/total"])
              for p in ("tp_only", "fsdp_tp") for s in SHAPES}
    for key, r in ratios.items():
        assert abs(r / RATIOS[key] - 1) <= RATIO_BAND, (key, r, RATIOS[key])
    for got in port.values():  # every kind present, one device's memory written
        assert set(got["collectives"]) == set(spmd.KINDS)
        mem = got["memory"]
        assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("shape,block", [("train_4k", "1024"), ("prefill_32k", "8192")])
def test_shortened_loops_equal_every_iteration(monkeypatch, shape, block):
    cfg = _cfg({**SMOKE_SET, "attn_block": block})
    mesh = Mesh((2, 4), ("data", "model"))
    short = _census(cfg, shape, mesh, "fsdp_tp")
    monkeypatch.setattr(accounting, "loop", lambda items, short, reps=None: items)
    full = _census(cfg, shape, mesh, "fsdp_tp")
    assert short["collectives"] == full["collectives"]
    assert short["memory"] == full["memory"]
    assert short["while_trip_counts"] and not full["while_trip_counts"]
    assert full["collectives_raw"] == {k: {"count": v["count"], "operand_bytes": v["bytes"]}
                                       for k, v in full["collectives"].items()}
    # the shortened run's body-once census counts each repeated body once
    assert (sum(v["count"] for v in short["collectives_raw"].values())
            < sum(v["count"] for v in short["collectives"].values()))


def test_placements_give_the_padded_block():
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        pairs = set()
        for arch in dryrun.LM_ARCHS:
            cfg = get_config(arch)
            tree = lm_param_tree(SH.abstract_module(cfg), device="meta")
            specs = POL.param_pspecs(tree, mesh, POL.POLICIES["fsdp_tp"], cfg)
            leaves = []
            POL.map_with_path(tree, lambda path, t: leaves.append(tuple(t.shape)))
            spec_leaves = []
            POL.map_with_path(specs, lambda path, s: spec_leaves.append(s))
            pairs |= set(zip(leaves, spec_leaves))
        pairs = {p for p in pairs if isinstance(p[1], PartitionSpec)}
        assert len(pairs) > 50
        with spmd.fake_world(mesh) as dmesh:
            for shape, spec in pairs:
                want = NamedSharding(mesh, spec).shard_shape(shape)
                assert spmd.local_shape(shape, spec, mesh) == want, (shape, spec)
                got, _ = compute_local_shape_and_global_offset(
                    shape, dmesh, spmd.to_placements(spec, mesh))
                assert tuple(got) == want, (shape, spec)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        spmd.to_placements(PartitionSpec(("model", "data")), make_production_mesh())


def test_no_process_group_left_behind(monkeypatch):
    r = dryrun.run_cell("stablelm-1.6b", "decode_32k", "single", overrides=SMOKE_SET)
    assert r["status"] == "ok" and not torch.distributed.is_initialized()

    def broken(*args, **kw):
        raise RuntimeError("a census that fails inside its world")
    monkeypatch.setattr(spmd, "partitioned_cell", broken)
    r = dryrun.run_cell("stablelm-1.6b", "decode_32k", "single", overrides=SMOKE_SET)
    assert r["status"] == "failed" and "inside its world" in r["error"]
    assert not torch.distributed.is_initialized()


def test_an_op_without_a_strategy_runs_whole():
    """An op that DTensor has no strategy for (one this file defines) runs on the
    local tensors of its inputs made whole: the all-gather that costs is
    counted, the output is whole, and the op is listed."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not hasattr(torch.ops.repro_torch_test, "twice"):
        def twice(x: torch.Tensor) -> torch.Tensor:
            return x * 2
        op = torch.library.custom_op("repro_torch_test::twice", mutates_args=())(twice)
        op.register_fake(lambda x: torch.empty_like(x))
    mesh = Mesh((2, 4), ("data", "model"))
    with spmd.fake_world(mesh) as dmesh:
        x = DTensor.from_local(torch.empty(8, 16, device="meta"), dmesh, [Shard(0), Shard(1)],
                               run_check=False, shape=(16, 64), stride=(64, 1))
        census = spmd.Census()
        with census:
            y = torch.ops.repro_torch_test.twice(x)
        assert isinstance(y, DTensor) and tuple(y.shape) == (16, 64)
        assert list(y.placements) == [Replicate(), Replicate()] and y.to_local().shape == (16, 64)
    got = census.result()
    assert got["replicated_ops"] == {"repro_torch_test.twice.default": 1}
    gathers = got["collectives"]["all-gather"]
    assert gathers["count"] == 2 and gathers["bytes"] == (8 * 16 + 8 * 64) * 4
    assert census.peak >= 16 * 64 * 4


def test_census_strategies_are_put_back():
    """The census's strategies hold for meta shards alone (its index_copy does not
    rebase the index), so they are DTensor's inside the census only: after one,
    the sharding propagator's entries of those ops are what they were, and a
    DTensor index_copy on real CPU tensors gives the plain result."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    ops = (aten.index_copy.default, aten.gather.default, aten.embedding.default,
           aten.new_zeros.default, aten.new_empty.default)
    tables = [getattr(prop, t) for t in spmd._PROP_TABLES if hasattr(prop, t)]

    def entries():
        return [(i, op, table.get(op)) for i, table in enumerate(tables) for op in ops]
    before = entries()
    _census(_cfg(), "decode_32k", Mesh((2, 4), ("data", "model")), "fsdp_tp")
    assert entries() == before and not torch.distributed.is_initialized()

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
        src, idx = -torch.ones(2, 4), torch.tensor([1, 4])
        got = distribute_tensor(x, mesh, [Shard(0)]).index_copy(
            0, distribute_tensor(idx, mesh, [Replicate()]),
            distribute_tensor(src, mesh, [Replicate()]))
        assert torch.equal(got.full_tensor(), x.index_copy(0, idx, src))
    finally:
        dist.destroy_process_group()


def test_a_marked_op_runs_its_body_or_the_takers_way():
    """`core.overrides.overridable`: without a taker a marked op is its body; inside
    `taking` the taker gets the op, the body and the arguments (the census's
    layout rules for flash attention, the CE, the SSD, ...), and after the
    block the body runs again."""
    from repro_torch.core import overrides

    @overrides.overridable
    def twice(x, *, by=2):
        return x * by

    x = torch.arange(3.0)
    assert torch.equal(twice(x), x * 2)
    seen = []

    def take(op, body, args, kwargs):
        seen.append((op, body.__name__, len(args), dict(kwargs)))
        return body(*args, **kwargs) + 1
    with overrides.taking(take):
        assert torch.equal(twice(x, by=3), x * 3 + 1)
    assert seen == [(twice, "twice", 1, {"by": 3})]
    assert torch.equal(twice(x), x * 2)
