"""The dry run: the op counter's cost model op by op, a dense smoke step counted
on the CPU and on meta, the counts against an analytic sum and against the
reference's `analyze` of the same jitted step, `run_cell` through `--set`
overrides, and the command line at full size for one decode cell.

The counter (`launch/hlo_analysis.py`) records aten ops, so a step counted
on the CPU and on meta tensors must give the same numbers (`==`); its dot
FLOPs must equal the sum over the step's linears and attention block
products.  Against the reference's HLO count the totals differ by op
granularity and fusion (see the bounds below), not by the dots.
"""

import json
import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_config as j_get_config
from repro.launch.hlo_analysis import analyze as j_analyze
from repro.models import families as JF
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.core import accounting
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.kernels.sc_matmul.ops import sc_matmul_op
from repro_torch.launch import dryrun, spmd
from repro_torch.launch import hlo_analysis as HA
from repro_torch.models.families import get_family_api
from repro_torch.models.layers import _flash_geometry
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import make_train_step

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 32


def _count(fn):
    return HA.analyze(fn)


# -- the cost model, op by op ---------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cost_model_op_by_op(device):
    a = torch.ones(6, 4, device=device)
    b = torch.ones(4, 5, device=device)
    r = _count(lambda: a @ b)
    assert (r["ops"], r["flops"], r["dot_flops"], r["bytes"]) == (1, 2 * 30 * 4, 240,
                                                                  (24 + 20 + 30) * 4)
    assert r["flops_by_type"] == {"float32": 240}
    r = _count(lambda: a.bfloat16() @ b.bfloat16())
    assert r["flops_by_type"] == {"bfloat16": 240, "vector": 24 + 20}  # two converts
    x = torch.ones(3, 6, 4, device=device)
    y = torch.ones(3, 4, 2, device=device)
    r = _count(lambda: torch.bmm(x, y))
    assert r["flops"] == 2 * 3 * 6 * 2 * 4 and r["ops_by_kind"] == {"dot": 1}
    bias = torch.ones(5, device=device)
    r = _count(lambda: torch.addmm(bias, a, b))
    assert r["flops"] == 2 * 30 * 4 and r["bytes"] == (5 + 24 + 20 + 30) * 4
    r = _count(lambda: a.sum(dim=-1))
    assert (r["flops"], r["bytes"], r["ops_by_kind"]) == (24, (24 + 6) * 4, {"reduce": 1})
    r = _count(lambda: torch.exp(a))
    assert (r["flops"], r["bytes"], r["ops_by_kind"]) == (24, 48 * 4, {"elementwise": 1})
    assert r["flops_by_type"] == {"vector": 24}
    h = torch.ones(6, 4, dtype=torch.bfloat16, device=device)
    r = _count(lambda: h.to(torch.float32))
    assert (r["flops"], r["bytes"]) == (24, 24 * 2 + 24 * 4)
    # views, allocations and iota are free
    r = _count(lambda: (a.t(), a.reshape(4, 6), a[1:3], a.permute(1, 0), a.unsqueeze(0),
                        torch.empty(7, device=device), torch.arange(9, device=device)))
    assert r["ops"] == 0 and r["flops"] == 0 and r["bytes"] == 0
    # a gather moves 2 x its result; a write into part of a tensor 2 x the update
    idx = torch.tensor([0, 2], device=device)
    r = _count(lambda: a.index_select(0, idx))
    assert (r["flops"], r["bytes"], r["ops_by_kind"]) == (8, 2 * 8 * 4, {"gather": 1})
    upd = torch.ones(6, 2, device=device)
    r = _count(lambda: a.index_copy(1, idx, upd))
    assert (r["flops"], r["bytes"], r["ops_by_kind"]) == (12, 2 * 12 * 4, {"write": 1})
    r = _count(lambda: torch.zeros(4, 5, device=device).index_put(
        (idx, idx), torch.ones(2, device=device)))
    assert r["ops_by_kind"] == {"elementwise": 2, "write": 1}  # two fills, the write
    assert r["bytes"] == 20 * 4 + 2 * 4 + 2 * 2 * 4

    def write_rows():
        out = torch.empty(6, 4, device=device)
        out[2:4] = a[0:2] * 2
    r = _count(write_rows)
    assert r["ops_by_kind"] == {"elementwise": 1, "write": 1}
    assert r["bytes"] == (8 + 8) * 4 + (8 + 8) * 4  # mul 8 in, 8 out; copy_ 8 read, 8 written
    assert r["collectives"] == {} and r["collective_bytes_total"] == 0


def test_sc_kernel_counts_as_one_op():
    xq = torch.randint(-100, 100, (8, 32), dtype=torch.int32)
    wq = torch.randint(-100, 100, (32, 16), dtype=torch.int32)
    flops, nbytes = HA.sc_matmul_cost(8, 32, 16, 4)
    for x, w in ((xq, wq), (xq.to("meta"), wq.to("meta"))):
        r = _count(lambda: sc_matmul_op(x, w, bits=16))
        assert (r["ops"], r["flops"], r["bytes"], r["dot_flops"]) == (1, flops, nbytes, flops)
        assert r["ops_by_kind"] == {"sc_matmul": 1}
        assert r["flops_by_type"] == {"sc_int8": flops}
    assert flops == 2 * 8 * 32 * 16 * 16 and nbytes == (8 * 32 + 32 * 16 + 8 * 16) * 4
    out = sc_matmul_op(xq.to("meta"), wq.to("meta"), bits=8)
    assert out.is_meta and out.shape == (8, 16) and out.dtype == torch.float32
    r = _count(lambda: sc_matmul_op(xq, wq, bits=8))
    assert r["flops"] == HA.sc_matmul_cost(8, 32, 16, 2)[0]


def test_repeat_and_loops():
    a = torch.ones(4, 4)
    with HA.counting() as cost:
        with accounting.repeat(3):
            torch.exp(a)
            with accounting.repeat(Fraction(1, 3)):
                torch.exp(a)
    c = cost()
    assert (c.ops, c.flops) == (4, 4 * 16)
    items = [1, 2, 3, 4, 5]
    assert list(accounting.loop(items, False)) == items
    with HA.counting() as cost:
        for _ in accounting.loop(items, True):
            torch.exp(a)
    assert cost().ops == 5
    with pytest.raises(RuntimeError):
        with HA.counting():
            with HA.counting():
                pass
    # without a counter the hooks do nothing
    assert accounting.kernel_call("x", lambda v: v + 1, 1) == 2
    with accounting.repeat(7):
        pass


# -- a dense smoke step, counted -------------------------------------------------------------


def _smoke(device):
    cfg = get_config("stablelm-1.6b", smoke=True)
    api = get_family_api(cfg)
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = api["init"](cfg, generator=gen, device=device)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
                           .astype(np.int32)).to(device)
    return cfg, api, params, tok


def _counts(device, quant="none"):
    cfg, api, params, tok = _smoke(device)
    pol = ExecutionPolicy(quant=quant)
    pre = _count(lambda: api["prefill"](params, cfg, {"tokens": tok}, S, policy=pol))
    step = make_train_step(cfg, policy=pol)
    opt = adamw_init(params)
    train = _count(lambda: step(params, opt, {"tokens": tok, "labels": tok}))
    return pre, train


def _analytic_dots(cfg):
    """(prefill, train step) dot FLOPs of the dense smoke config at B x S, float."""
    d, hq, hkv, dh, f, v, nl = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                cfg.d_ff, cfg.vocab_size, cfg.n_layers)
    m = B * S
    attn_proj = 2 * m * d * (hq * dh + 2 * hkv * dh) + 2 * m * hq * dh * d
    mlp = 3 * 2 * m * d * f  # GLU: wi, wg, wo
    wo = 2 * m * f * d
    blk, pairs = _flash_geometry(S, S, True, None, cfg.attn_block)
    pair = 2 * B * hq * blk * blk * dh  # one block product: q k^T, or p v
    prefill = nl * (attn_proj + mlp + len(pairs) * 2 * pair) + 2 * B * d * v  # last position
    ce = 2 * m * d * v
    # remat "full": each layer's forward again in the backward, up to its last saved
    # tensor (torch's checkpoint stops early there), so wo's product, the layer's last,
    # runs once; the backward takes 2 products a linear; the flash attention 2 products a
    # pair forward, 2 recomputed, 5 in its backward (s, dV, dP, dQ, dK); the chunked cross
    # entropy's logits forward, recomputed, and 2 backward
    train = nl * (4 * (attn_proj + mlp) - wo + 9 * len(pairs) * pair) + 4 * ce
    return prefill, train


def test_dense_step_counted_on_cpu_and_meta():
    cfg = get_config("stablelm-1.6b", smoke=True)
    pre_cpu, train_cpu = _counts("cpu")
    pre_meta, train_meta = _counts("meta")
    for a, b in ((pre_cpu, pre_meta), (train_cpu, train_meta)):
        assert (a["ops"], a["flops"], a["bytes"], a["dot_flops"]) == (
            b["ops"], b["flops"], b["bytes"], b["dot_flops"])
    want_pre, want_train = _analytic_dots(cfg)
    assert pre_cpu["dot_flops"] == want_pre
    assert train_cpu["dot_flops"] == want_train
    # under SC every linear is one kernel call, the same on the CPU and on meta
    sc_cpu, sc_meta = _counts("cpu", "sc_w16a16"), _counts("meta", "sc_w16a16")
    for a, b in zip(sc_cpu, sc_meta):
        assert a == b
    assert sc_cpu[0]["ops_by_kind"]["sc_matmul"] == 7 * cfg.n_layers
    assert sc_cpu[1]["ops_by_kind"]["sc_matmul"] == 2 * 7 * cfg.n_layers  # + the recompute
    for r in (pre_cpu, train_cpu, *sc_cpu):
        assert sum(r["flops_by_type"].values()) == r["flops"]


def test_roofline_terms_take_one_peak_a_type():
    cost = {"flops_by_type": {"bfloat16": 4e12, "float32": 1e12, "vector": 2e12},
            "bytes": 6e12}
    peaks = {"bfloat16": 1e15, "float32": 5e13, "vector": 4e13}
    r = HA.roofline_ms(cost, 2, peaks, 3e12)
    assert r["compute_ms_by_type"] == pytest.approx(
        {"bfloat16": 2.0, "float32": 10.0, "vector": 25.0})
    assert r["compute_ms"] == pytest.approx(37.0)
    assert r["memory_ms"] == pytest.approx(1000.0) and r["bound_by"] == "bytes"
    # the census's collective term is reported beside the bound, never in it
    r = HA.roofline_ms({**cost, "collective_bytes_total": 9e12}, 2, peaks, 3e12, 1e9)
    assert r["collective_ms"] == pytest.approx(9e6) and r["bound_by"] == "bytes"
    with pytest.raises(KeyError):
        HA.roofline_ms(cost, 1, {"bfloat16": 1e15}, 3e12)


def test_counts_near_the_reference_analysis():
    cfg = get_config("stablelm-1.6b", smoke=True)
    pre, train = _counts("meta")
    jcfg = j_get_config("stablelm-1.6b", smoke=True)
    api = JF.get_family_api(jcfg)
    params = api["init"](jax.random.PRNGKey(0), jcfg)
    tok = jnp.zeros((B, S), jnp.int32)
    hlo = jax.jit(lambda p, b: api["prefill"](p, jcfg, b, S)).lower(
        params, {"tokens": tok}).compile().as_text()
    j_pre = j_analyze(hlo)["flops"]
    hlo = jax.jit(j_make_train_step(jcfg)).lower(
        params, j_adamw_init(params), {"tokens": tok, "labels": tok}).compile().as_text()
    j_train = j_analyze(hlo)["flops"]
    # measured: prefill 14,110,017 / 14,713,788 = 0.959, train 64,978,358 / 66,825,799 =
    # 0.972.  The dots agree; the rest is op granularity (one `_softmax` against XLA's
    # reduces and elementwise ops, XLA's converts and broadcasts inside fusions) and the
    # remat: XLA recomputes a layer's whole body, torch's checkpoint stops at its last
    # saved tensor
    assert 0.93 <= pre["flops"] / j_pre <= 1.0
    assert 0.93 <= train["flops"] / j_train <= 1.0
    assert pre["flops"] > pre["dot_flops"] and train["flops"] > train["dot_flops"]


# -- run_cell and the command line -----------------------------------------------------------

SMOKE_SET = {"n_layers": "2", "d_model": "64", "n_heads": "4", "n_kv_heads": "2",
             "d_ff": "128", "vocab_size": "256"}
REF_KEYS = {"arch", "shape", "mesh", "policy", "n_devices", "overrides", "microbatch",
            "memory_analysis", "cost_analysis", "hlo_analysis", "collectives_raw",
            "while_trip_counts", "hlo_bytes", "model_flops", "param_count", "lower_s",
            "compile_s", "status"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp2d"])
def test_run_cell_smoke_overrides(shape, policy):
    over = dict(SMOKE_SET)
    r = dryrun.run_cell("stablelm-1.6b", shape, "multi", policy, over,
                        microbatch=2 if shape == "train_4k" else None)
    assert r["status"] == "ok", r.get("traceback")
    assert set(r) == REF_KEYS
    assert r["n_devices"] == 512 and r["overrides"] == over
    assert r["compile_s"] is None and r["hlo_bytes"] is None and r["cost_analysis"] is None
    # one device's census (launch/spmd.py): every kind, body-once and trip-count-scaled
    assert set(r["collectives_raw"]) == set(spmd.KINDS)
    assert all(isinstance(n, (int, float)) for n in r["while_trip_counts"])
    mem = r["memory_analysis"]
    assert mem["available"] and mem["argument_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] is None
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] >= 0 and mem["output_size_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] > 0  # train donates params and state, decode the state
    h = r["hlo_analysis"]
    assert h["flops"] > h["dot_flops"] > 0
    assert set(h["collectives"]) == set(spmd.KINDS) and h["collective_bytes_total"] > 0
    assert h["collective_bytes_total"] == sum(v["bytes"] for v in h["collectives"].values())
    cfg = dryrun.apply_overrides(get_config("stablelm-1.6b"), over)
    assert r["param_count"] == cfg.param_count() and cfg.n_layers == 2
    from repro_torch.launch.shapes import model_flops
    assert r["model_flops"] == model_flops(cfg, shape)


def test_run_cell_argument_bytes():
    over = dict(SMOKE_SET)
    cfg = dryrun.apply_overrides(get_config("granite-moe-3b-a800m"), {**over, "n_experts": "4",
                                                                      "top_k": "2"})
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    batch = SH.input_specs(cfg, "train_4k")
    args, shardings = dryrun.cell_arguments(cfg, "train", batch, mesh, "fsdp_tp")
    got = dryrun.argument_bytes(args, shardings)
    want = 0
    for t, s in dryrun._pairs(args, shardings):
        shard = [-(-n // s.ways(d)) for d, n in enumerate(t.shape)]
        want += int(np.prod(shard)) * t.element_size()
    assert got == want
    one = dryrun.cell_arguments(cfg, "train", batch, mesh, "dp_only")
    full = sum(t.numel() * t.element_size() for t, _ in dryrun._pairs(*one))
    assert dryrun.argument_bytes(*one) < full  # the batch still splits over "data"


def test_run_cell_skips_and_failures():
    r = dryrun.run_cell("stablelm-1.6b", "long_500k", "single")
    assert r == {"arch": "stablelm-1.6b", "shape": "long_500k", "mesh": "single",
                 "status": "skipped",
                 "reason": "full-attention arch: long_500k skipped per assignment rule"}
    r = dryrun.run_cell("stablelm-1.6b", "decode_32k", "single", overrides={"nope": "1"})
    assert r["status"] == "failed" and "AttributeError" in r["error"]


def test_cli_full_size_decode_cell(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "mamba2-1.3b", "--shape", "decode_32k", "--mesh", "multi", "--out",
                        str(out), "--out-dir", str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[ok     ] mamba2-1.3b x decode_32k x multi" in p.stdout
    r = json.loads(out.read_text())
    assert r["status"] == "ok" and r["n_devices"] == 512 and r["hlo_analysis"]["flops"] > 0
    from repro.configs import get_config as jcfg
    from repro.launch.shapes import model_flops as j_model_flops
    assert r["model_flops"] == j_model_flops(jcfg("mamba2-1.3b"), "decode_32k")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "stablelm-1.6b", "--shape", "long_500k", "--out-dir", str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "[skipped] stablelm-1.6b x long_500k x single" in p.stdout
    assert (tmp_path / "stablelm-1.6b__long_500k__single__fsdp_tp.json").exists()
