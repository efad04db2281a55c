"""Port parity, LM layers: RMSNorm, RoPE, flash attention, decode attention
(float and int8 caches), the KV quantizer, the attention block and the MLPs,
against the JAX package's `models/layers.py` on the same numpy inputs.

Every JAX reference is computed once, in the module-scoped `ref` fixture.

Tolerances and why:
  * float32 elementwise ops (RMSNorm, RoPE): the same formulas, evaluated
    op by op; XLA may fuse and reorder a reduction (~1 ulp): atol 1e-6;
  * attention and the MLPs: the matmuls and softmax sums run in other
    orders (~1e-7 relative a product): atol 2e-6 / 1e-5;
  * the int8 KV quantizer: bitwise (one division and one round a value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.models import layers as JL
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import layers as TL

jax.config.update("jax_platform_name", "cpu")

ELEM_ATOL = 1e-6
ATTN_ATOL = 2e-6
MLP_ATOL = 1e-5

# the reference's own flash cases (tests/test_flash_attention.py), then two
# whose block does not divide the length
FLASH_CASES = [
    dict(causal=True, window=None, s=64, sk=64, hq=4, hkv=2, block=16),
    dict(causal=True, window=16, s=64, sk=64, hq=4, hkv=4, block=16),
    dict(causal=True, window=8, s=48, sk=48, hq=2, hkv=1, block=16),
    dict(causal=False, window=None, s=32, sk=48, hq=4, hkv=1, block=16),
    dict(causal=True, window=None, s=96, sk=96, hq=8, hkv=2, block=16),
    dict(causal=True, window=None, s=48, sk=48, hq=4, hkv=2, block=32),
    dict(causal=True, window=12, s=40, sk=40, hq=4, hkv=1, block=16),
]
DH = 16
B, S_CACHE, HQ, HKV = 3, 24, 4, 2
# (cache_len, window) of the decode cases: a scalar, one a batch row, a window
DECODE_CASES = [(9, None), (np.array([1, 17, 24], np.int32), None), (20, 6)]
ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8, rope_theta=10000.0)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {
        "norm_x": f(2, 5, 64), "norm_g": (1.0 + 0.1 * f(64)).astype(np.float32),
        "rope_x": f(2, 12, 3, 16), "rope_pos": np.stack([np.arange(12), 5 + np.arange(12)]),
        "flash": [(f(2, c["s"], c["hq"], DH), f(2, c["sk"], c["hkv"], DH),
                   f(2, c["sk"], c["hkv"], DH)) for c in FLASH_CASES],
        "q1": f(B, 1, HQ, DH), "kc": f(B, S_CACHE, HKV, DH), "vc": f(B, S_CACHE, HKV, DH),
        "attn_x": f(2, 6, ATTN["d_model"]), "attn_tok": f(2, 1, ATTN["d_model"]),
        "attn_w": {n: (f(*shape) / np.sqrt(shape[0])).astype(np.float32) for n, shape in
                   {"wq": (32, 32), "wk": (32, 16), "wv": (32, 16), "wo": (32, 32)}.items()},
        "mlp_x": f(2, 7, 24),
        "mlp_w": {n: (f(*shape) / np.sqrt(shape[0])).astype(np.float32) for n, shape in
                  {"wi": (24, 40), "wg": (24, 40), "wo": (40, 24)}.items()},
        "mlp_b": {"wi": f(40), "wo": f(24)},
    }


def _jcache(kc, vc):
    kq, ks = JL.quantize_kv(jnp.asarray(kc))
    vq, vs = JL.quantize_kv(jnp.asarray(vc))
    return JL.QuantKVCache(kq, vq, ks, vs)


def _attn_tree(w):
    return {n: {"w": jnp.asarray(v)} for n, v in w.items()}


@pytest.fixture(scope="module")
def ref(inputs):
    """Every JAX reference of this file, computed once."""
    x = inputs
    out = {
        "rms": _np(JL.rmsnorm({"g": jnp.asarray(x["norm_g"])}, jnp.asarray(x["norm_x"]))),
        "rope": _np(JL.apply_rope(jnp.asarray(x["rope_x"]), jnp.asarray(x["rope_pos"]),
                                  10000.0)),
        "flash": [_np(JL.flash_attention(*map(jnp.asarray, qkv), causal=c["causal"],
                                         window=c["window"], block=c["block"]))
                  for c, qkv in zip(FLASH_CASES, x["flash"])],
        "quant_kv": [_np(a) for a in JL.quantize_kv(jnp.asarray(x["kc"]))],
    }
    jc = _jcache(x["kc"], x["vc"])
    out["decode"] = [_np(JL.decode_attention(jnp.asarray(x["q1"]), jnp.asarray(x["kc"]),
                                             jnp.asarray(x["vc"]), cache_len=jnp.asarray(n),
                                             window=w)) for n, w in DECODE_CASES]
    out["decode_quant"] = [_np(JL.decode_attention_quant(jnp.asarray(x["q1"]), jc,
                                                         cache_len=jnp.asarray(n), window=w))
                           for n, w in DECODE_CASES]
    acfg = JL.AttnConfig(**ATTN)
    tree = _attn_tree(x["attn_w"])
    pos = jnp.arange(6)[None]
    y, (k, v) = JL.attn_apply(tree, acfg, jnp.asarray(x["attn_x"]), positions=pos,
                              collect_kv=True, attn_block=4)
    out["attn_prefill"] = (_np(y), _np(k), _np(v))
    # decode against a 6-entry cache: a write at 2, and a write past the end
    cache = JL.KVCache(k, v)
    (kq, ks), (vq, vs) = JL.quantize_kv(k), JL.quantize_kv(v)
    qcache = JL.QuantKVCache(kq, vq, ks, vs)
    out["attn_decode"] = {}
    for name, c in (("float", cache), ("int8", qcache)):
        for idx in (2, 9):
            y, nc = JL.attn_apply(tree, acfg, jnp.asarray(x["attn_tok"]),
                                  positions=jnp.full((1, 1), idx), cache=c,
                                  write_idx=jnp.asarray(idx, jnp.int32),
                                  attend_len=jnp.asarray(min(idx + 1, 6), jnp.int32))
            out["attn_decode"][name, idx] = (_np(y), [_np(a) for a in nc])
    mtree = {n: {"w": jnp.asarray(w), **({"b": jnp.asarray(x["mlp_b"][n])}
                                         if n in x["mlp_b"] else {})}
             for n, w in x["mlp_w"].items()}
    glu = {n: {"w": t["w"]} for n, t in mtree.items()}
    dense = {n: mtree[n] for n in ("wi", "wo")}
    xm = jnp.asarray(x["mlp_x"])
    out["mlp"] = {}
    for act in ("silu", "gelu", "relu"):
        out["mlp"]["glu", act] = _np(JL.glu_mlp_apply(glu, xm, act=act))
        out["mlp"]["dense", act] = _np(JL.dense_mlp_apply(dense, xm, act=act))
    out["mlp"]["glu", "sc"] = _np(JL.glu_mlp_apply(glu, xm, act="silu",
                                                   policy=JPolicy(quant="sc_w16a16")))
    return out


# -- norms and RoPE ---------------------------------------------------------------------


def test_rmsnorm(inputs, ref):
    norm = TL.RMSNorm(64)
    with torch.no_grad():
        norm.g.copy_(_t(inputs["norm_g"]))
        got = norm(_t(inputs["norm_x"])).numpy()
    np.testing.assert_allclose(got, ref["rms"], rtol=0, atol=ELEM_ATOL)


def test_rmsnorm_keeps_bf16():
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    norm = TL.RMSNorm(8, dtype=torch.bfloat16)
    assert norm(x).dtype == torch.bfloat16 and norm.g.dtype == torch.bfloat16


def test_apply_rope(inputs, ref):
    got = TL.apply_rope(_t(inputs["rope_x"]), _t(inputs["rope_pos"]), 10000.0).numpy()
    np.testing.assert_allclose(got, ref["rope"], rtol=0, atol=ELEM_ATOL)


def test_gelu_is_the_tanh_approximation():
    x = torch.tensor([1.0])
    assert abs(TL.ACTS["gelu"](x).item() - float(jax.nn.gelu(jnp.float32(1.0)))) < 1e-7
    assert abs(TL.ACTS["gelu"](x).item() - 0.841192) < 1e-6


# -- flash attention -------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(FLASH_CASES)),
                         ids=[f"s{c['s']}-w{c['window']}-c{int(c['causal'])}-blk{c['block']}"
                              for c in FLASH_CASES])
def test_flash_attention(inputs, ref, i):
    c = FLASH_CASES[i]
    q, k, v = map(_t, inputs["flash"][i])
    got = TL.flash_attention(q, k, v, causal=c["causal"], window=c["window"], block=c["block"])
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(got.numpy(), ref["flash"][i], rtol=0, atol=ATTN_ATOL)


def test_flash_geometry_matches_the_reference():
    for s, sk, causal, window, block in [(48, 48, True, None, 32), (40, 40, True, 12, 16),
                                         (1280, 1280, True, 1024, 512), (32, 48, False, None, 16),
                                         (128, 128, True, None, 512)]:
        assert TL._flash_geometry(s, sk, causal, window, block) == \
            JL._flash_geometry(s, sk, causal, window, block)


def test_flash_attention_rejects_causal_cross_lengths():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="q_len == kv_len"):
        TL.flash_attention(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8))


# -- decode attention and the int8 cache ----------------------------------------------


def test_quantize_kv_bitwise(inputs, ref):
    q, s = TL.quantize_kv(_t(inputs["kc"]))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), ref["quant_kv"][0])
    np.testing.assert_array_equal(s.numpy(), ref["quant_kv"][1])
    back = TL.dequantize_kv(q, s, torch.float32)
    np.testing.assert_allclose(back.numpy(), inputs["kc"], atol=float(s.max()) / 2 + 1e-7)


@pytest.mark.parametrize("i", range(len(DECODE_CASES)), ids=["len9", "per-row", "window6"])
def test_decode_attention(inputs, ref, i):
    n, w = DECODE_CASES[i]
    got = TL.decode_attention(_t(inputs["q1"]), _t(inputs["kc"]), _t(inputs["vc"]),
                              cache_len=torch.as_tensor(n), window=w)
    np.testing.assert_allclose(got.numpy(), ref["decode"][i], rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("i", range(len(DECODE_CASES)), ids=["len9", "per-row", "window6"])
def test_decode_attention_quant(inputs, ref, i):
    n, w = DECODE_CASES[i]
    kq, ks = TL.quantize_kv(_t(inputs["kc"]))
    vq, vs = TL.quantize_kv(_t(inputs["vc"]))
    got = TL.decode_attention_quant(_t(inputs["q1"]), TL.QuantKVCache(kq, vq, ks, vs),
                                    cache_len=torch.as_tensor(n), window=w)
    np.testing.assert_allclose(got.numpy(), ref["decode_quant"][i], rtol=0, atol=ATTN_ATOL)


# -- the attention block -----------------------------------------------------------------


def _attention(inputs):
    attn = TL.Attention(TL.AttnConfig(**ATTN))
    with torch.no_grad():
        for n, w in inputs["attn_w"].items():
            getattr(attn, n).w.copy_(_t(w))
    return attn


def test_attention_prefill_collects_kv(inputs, ref):
    attn = _attention(inputs)
    with torch.no_grad():
        y, (k, v) = attn(_t(inputs["attn_x"]), positions=torch.arange(6)[None],
                         collect_kv=True, attn_block=4)
    for got, want in zip((y, k, v), ref["attn_prefill"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MLP_ATOL)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("idx", [2, 9], ids=["in-range", "past-the-end"])
def test_attention_decode_writes_at_a_clamped_index(inputs, ref, kind, idx):
    """The reference's update clamps its start: a write past the cache's end lands
    on its last slot (hazard 3); cache_len and write_idx stay tensors."""
    attn = _attention(inputs)
    _, k, v = (torch.from_numpy(a.copy()) for a in ref["attn_prefill"])
    cache = TL.KVCache(k.clone(), v.clone())
    if kind == "int8":
        (kq, ks), (vq, vs) = TL.quantize_kv(k), TL.quantize_kv(v)
        cache = TL.QuantKVCache(kq, vq, ks, vs)
    before = [t.clone() for t in cache]
    with torch.no_grad():
        y, nc = attn(_t(inputs["attn_tok"]), positions=torch.full((1, 1), idx),
                     cache=cache, write_idx=torch.tensor(idx, dtype=torch.int32),
                     attend_len=torch.tensor(min(idx + 1, 6), dtype=torch.int32))
    want_y, want_cache = ref["attn_decode"][kind, idx]
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=MLP_ATOL)
    slot = min(idx, 5)
    for got, want, old in zip(nc, want_cache, before):
        assert got.dtype == old.dtype and got.shape == old.shape
        keep = [j for j in range(6) if j != slot]
        assert torch.equal(got[:, keep], old[:, keep])  # only the clamped slot changed
        if kind == "int8" and got.dtype == torch.int8:
            # int8 values within one step of the reference's (their float inputs
            # differ by matmul order)
            assert (got.to(torch.int32) - torch.from_numpy(want.copy()).to(torch.int32)).abs().max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MLP_ATOL)
    for t, old in zip(cache, before):  # the input cache is left as it was
        assert torch.equal(t, old)


@pytest.mark.parametrize("query", ["attn_x", "attn_tok"], ids=["six", "one"])
def test_attention_refuses_kv_override(inputs, query):
    """The name predates the encdec family: `kv_override` (cross-attention) now
    runs, against the reference's attn_apply.  A query of 6 positions over the 6
    of attn_x (non-causal flash attention, no RoPE on either side) and a
    one-token query (decode attention over all 6); aux is the projected (k, v)
    only when collect_kv asks for it."""
    attn = _attention(inputs)
    x, src = inputs[query], inputs["attn_x"]
    pos = np.arange(x.shape[1])[None]
    want, _ = JL.attn_apply(_attn_tree(inputs["attn_w"]), JL.AttnConfig(**ATTN), jnp.asarray(x),
                            positions=jnp.asarray(pos), kv_override=(jnp.asarray(src),) * 2,
                            attn_block=4)
    with torch.no_grad():
        got, aux = attn(_t(x), positions=_t(pos), kv_override=(_t(src),) * 2, attn_block=4)
        _, (k, v) = attn(_t(x), positions=_t(pos), kv_override=(_t(src),) * 2,
                         collect_kv=True, attn_block=4)
    assert aux is None and k.shape == v.shape == (2, 6, ATTN["n_kv_heads"], ATTN["d_head"])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=MLP_ATOL)


@pytest.mark.parametrize("query", ["attn_x", "attn_tok"], ids=["six", "one"])
def test_attention_kv_override_takes_the_projected_cache(inputs, query):
    """A KVCache as `kv_override` (the decoder's cross cache) is taken as the
    projected K/V: the same output, bitwise, as projecting the source again."""
    attn = _attention(inputs)
    x, src = _t(inputs[query]), _t(inputs["attn_x"])
    pos = torch.arange(x.shape[1])[None]
    with torch.no_grad():
        want, (k, v) = attn(x, positions=pos, kv_override=(src, src), collect_kv=True,
                            attn_block=4)
        got, aux = attn(x, positions=pos, kv_override=TL.KVCache(k, v), attn_block=4)
    assert aux is None
    assert torch.equal(got, want)


# -- MLPs ------------------------------------------------------------------------------


def _mlps(inputs, act):
    glu = TL.GLUMLP(24, 40, bias=False, act=act)
    dense = TL.DenseMLP(24, 40, bias=True, act=act)
    with torch.no_grad():
        for n, w in inputs["mlp_w"].items():
            getattr(glu, n).w.copy_(_t(w))
            if n != "wg":
                getattr(dense, n).w.copy_(_t(w))
                getattr(dense, n).b.copy_(_t(inputs["mlp_b"][n]))
    return glu, dense


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlps(inputs, ref, act):
    glu, dense = _mlps(inputs, act)
    x = _t(inputs["mlp_x"])
    with torch.no_grad():
        np.testing.assert_allclose(glu(x).numpy(), ref["mlp"]["glu", act], rtol=0,
                                   atol=MLP_ATOL)
        np.testing.assert_allclose(dense(x).numpy(), ref["mlp"]["dense", act], rtol=0,
                                   atol=MLP_ATOL)


def test_glu_mlp_under_sc(inputs, ref):
    """Under SC W16A16 every linear runs the SC path (its plain version here):
    the integer products are exact, the float differences around them ~1e-7."""
    glu, _ = _mlps(inputs, "silu")
    with torch.no_grad():
        got = glu(_t(inputs["mlp_x"]), policy=ExecutionPolicy(quant="sc_w16a16")).numpy()
    np.testing.assert_allclose(got, ref["mlp"]["glu", "sc"], rtol=0, atol=MLP_ATOL)
