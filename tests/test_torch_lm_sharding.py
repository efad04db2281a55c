"""Port parity, the LM's device layout: the production and host meshes, the
partitioning rules (parameters, AdamW state, batches, decode states) and
the activation hints, against the JAX package.

The rules are pure functions of shapes, paths and the mesh's axis sizes:
the port's specs must equal the reference's leaf for leaf (by tree path)
for every policy, arch and production mesh, the reference's run on
`jax.sharding.AbstractMesh` (no devices needed).  The hints' specs are
recorded on the JAX side through a monkeypatched
`jax.lax.with_sharding_constraint` and on the port's through
`hints._constrain`; each family's smoke config runs under a host mesh with
answers bitwise equal to the same calls without it.  The reference's
scans trace a layer's body once, so the hint sites compare as sets of
(shape, spec).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_config as j_get_config
from repro.launch import shapes as JSH
from repro.models import families as JF
from repro.sharding import hints as JH
from repro.sharding import policy as JPOL
from repro_torch.configs import get_config
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models.families import get_family_api
from repro_torch.params import lm_layout, named_jax_params
from repro_torch.sharding import hints as H
from repro_torch.sharding import policy as POL
from repro_torch.sharding.spec import NamedSharding, PartitionSpec, place

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["stablelm-1.6b", "gemma3-12b", "command-r-plus-104b", "starcoder2-3b", "dbrx-132b",
         "granite-moe-3b-a800m", "mamba2-1.3b", "recurrentgemma-2b", "whisper-small",
         "internvl2-2b"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(kind):
    return AbstractMesh(*MESHES[kind])


def _pmesh(kind):
    return make_production_mesh(multi_pod=(kind == "multi"))


def _jflat(tree) -> dict:
    """{reference path string: spec as a tuple} of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.NamedSharding)))
    out = {}
    for path, leaf in flat:
        spec = leaf.spec if isinstance(leaf, jax.sharding.NamedSharding) else leaf
        out[JPOL._path_str(path)] = tuple(spec)
    return out


def _pflat(tree, path: str = "") -> dict:
    """{path string: spec as a tuple} of a port spec tree (`policy.map_with_path`'s paths)."""
    if tree is None:
        return {}
    if isinstance(tree, NamedSharding):
        return {path: tuple(tree.spec)}
    if isinstance(tree, PartitionSpec):
        return {path: tuple(tree)}
    join = (lambda k: f"{path}/{k}") if path else (lambda k: f"{k}")
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _pflat(v, join(k)).items()}
    if hasattr(tree, "_fields"):
        return {p: s for f, v in zip(tree._fields, tree) for p, s in _pflat(v, join(f".{f}")).items()}
    return {p: s for i, v in enumerate(tree) for p, s in _pflat(v, join(i)).items()}


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    cfg = j_get_config(arch)
    params = JSH.abstract_params(cfg)
    opt = jax.eval_shape(lambda: JSH.adamw_init_from_shapes(params))
    states = {s: JSH.decode_state_specs(cfg, s) for s, i in JSH.SHAPES.items()
              if i["kind"] == "decode"}
    return cfg, params, opt, states


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    cfg = get_config(arch)
    params = SH.abstract_params(cfg)
    opt = SH.adamw_init_from_shapes(params)
    states = {s: SH.decode_state_specs(cfg, s) for s, i in SH.SHAPES.items()
              if i["kind"] == "decode"}
    return cfg, params, opt, states


# -- meshes -----------------------------------------------------------------------------


def test_production_and_host_meshes():
    for kind, (shape, axes) in MESHES.items():
        m = _pmesh(kind)
        assert m.axis_names == axes and tuple(m.shape.values()) == shape
        assert list(m.shape) == list(_jmesh(kind).axis_names)
        assert m.devices is None and m.size == int(np.prod(shape))
    h = make_host_mesh(device="cpu")
    assert h.shape == {"data": 1, "model": 1} and h.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data", "model"), devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_host_mesh()


# -- partitioning rules -----------------------------------------------------------------


@pytest.mark.parametrize("policy", sorted(POL.POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, policy):
    jcfg, jparams, jopt, jstates = _jax_shapes(arch)
    cfg, params, opt, states = _port_shapes(arch)
    for kind in MESHES:
        jm, pm = _jmesh(kind), _pmesh(kind)
        jpol, ppol = JPOL.POLICIES[policy], POL.POLICIES[policy]
        jps = JPOL.param_pspecs(jparams, jm, jpol, jcfg)
        pps = POL.param_pspecs(params, pm, ppol, cfg)
        assert _pflat(pps) == _jflat(jps), (arch, policy, kind)
        assert len(_pflat(pps)) == len(jax.tree.leaves(jparams))
        assert (_pflat(POL.state_pspecs(opt, pps, pm))
                == _jflat(JPOL.state_pspecs(jopt, jps, jm))), (arch, policy, kind)
        for shape in SH.SHAPES:
            assert (_pflat(POL.batch_pspecs(cfg, SH.input_specs(cfg, shape), pm, ppol))
                    == _jflat(JPOL.batch_pspecs(jcfg, JSH.input_specs(jcfg, shape), jm, jpol))
                    ), (arch, policy, kind, shape)
        for shape, st in states.items():
            assert (_pflat(POL.decode_state_pspecs(cfg, st, pm, ppol))
                    == _jflat(JPOL.decode_state_pspecs(jcfg, jstates[shape], jm, jpol))
                    ), (arch, policy, kind, shape)
        shardings = POL.to_shardings(pps, pm)
        assert _pflat(shardings) == _pflat(pps)
        assert POL.to_shardings(shardings, pm) == shardings  # idempotent


def test_reference_quirks_kept():
    cfg, params, _, _ = _port_shapes("mamba2-1.3b")
    specs = POL.param_pspecs(params, _pmesh("single"), POL.POLICIES["fsdp_tp"], cfg)
    assert tuple(specs["blocks"]["mixer"]["A_log"]) == ("data", "model")  # (L, H): not "stacked"
    assert tuple(specs["blocks"]["mixer"]["in_proj"]["w"]) == (None, "data", "model")
    cfg, params, _, _ = _port_shapes("dbrx-132b")
    specs = POL.param_pspecs(params, _pmesh("single"), POL.POLICIES["fsdp_tp"], cfg)
    # the expert rule wants (E, d, f); stacked over the layers the leaf has four dims, so
    # it takes the generic rule: layers whole, d over "data", f over "model"
    assert tuple(specs["blocks"][0]["mlp"]["wi"]) == (None, "data", None, "model")
    assert tuple(POL._spec_for_weight("blocks/0/mlp/wi", (16, 6144, 10752), _pmesh("single"),
                                      POL.POLICIES["fsdp_tp"], cfg)) == ("model", "data", None)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-2b", "mamba2-1.3b",
                                  "whisper-small"])
def test_module_pspecs_drop_the_stacked_dim(arch):
    cfg = get_config(arch, smoke=True)
    module = SH.abstract_module(cfg)
    from repro_torch.params import lm_leaf_key, lm_param_tree
    tree = lm_param_tree(module, device="meta")
    mesh = _pmesh("multi")
    specs = POL.param_pspecs(tree, mesh, POL.POLICIES["fsdp_tp"], cfg)
    per_layer = POL.module_pspecs(module, POL.to_shardings(specs, mesh))
    layout = lm_layout(cfg)
    for name, p in named_jax_params(module).items():
        path, group = lm_leaf_key(name, layout)
        node = specs
        for part in path:
            node = node[part]
        want = tuple(node)[1:] if group is not None else tuple(node)
        assert tuple(per_layer[name].spec) == want, name
        assert len(want) <= p.ndim


def test_shard_shape_pads():
    mesh = _pmesh("multi")
    s = NamedSharding(mesh, PartitionSpec(("pod", "data"), "model", None))
    assert s.shard_shape((64, 48, 7)) == (2, 3, 7)
    assert s.shard_shape((33, 17, 7)) == (2, 2, 7)  # ceil: the last block padded
    assert NamedSharding(mesh, PartitionSpec()).shard_shape((5, 6)) == (5, 6)
    assert NamedSharding(mesh, PartitionSpec("model")).shard_shape((40, 3)) == (3, 3)
    e = NamedSharding(_pmesh("single"), PartitionSpec("model", "data", None))
    assert e.shard_shape((40, 1536, 512)) == (3, 96, 512)  # 40 experts over 16: padded
    assert e.shard_nbytes(torch.empty((40, 1536, 512), dtype=torch.bfloat16,
                                      device="meta")) == 3 * 96 * 512 * 2
    assert PartitionSpec(("data",), ()) == PartitionSpec("data", None)
    with pytest.raises(ValueError):
        NamedSharding(mesh, PartitionSpec("nope"))
    host = make_host_mesh(device="cpu")
    t = torch.arange(12.0).reshape(3, 4)
    placed = place(t, NamedSharding(host, PartitionSpec(("data", "model"), None)))
    assert torch.equal(placed, t) and placed.data_ptr() != t.data_ptr()
    with pytest.raises(ValueError):
        place(t, NamedSharding(mesh, PartitionSpec()))


# -- activation hints -----------------------------------------------------------------------


def _jax_hint_specs(monkeypatch, mesh, mode, fn):
    seen = set()

    def record(x, sharding):
        seen.add((tuple(x.shape), tuple(sharding.spec)))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    with JH.activation_sharding(mesh, mode=mode):
        fn()
    monkeypatch.undo()
    return seen


def _port_hint_specs(monkeypatch, mesh, mode, fn):
    seen = set()

    def record(x, mesh, spec):
        sharding = NamedSharding(mesh, spec)  # validates the spec's axes on the mesh
        seen.add((tuple(x.shape), tuple(sharding.spec)))
        return x

    monkeypatch.setattr(H, "_constrain", record)
    with H.activation_sharding(mesh, mode=mode):
        out = fn()
    monkeypatch.undo()
    return seen, out


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("mode", ["sp", "fsdp2d", "off"])
def test_hint_specs_equal_reference(monkeypatch, mode, kind):
    import jax.numpy as jnp

    shapes = [(b, s, 8) for b in (1, 2, 16, 32, 256, 512, 768) for s in (1, 8, 16, 48, 4096)]
    shapes += [(4,), (32, 5), (512, 1, 8, 2), (7, 16, 8)]
    for shape in shapes:
        x = jnp.zeros(shape, jnp.float32)
        want = _jax_hint_specs(monkeypatch, _jmesh(kind), mode,
                               lambda: (JH.hint_residual(x), JH.hint_batch_only(x)))
        t = torch.zeros(shape)
        got, out = _port_hint_specs(monkeypatch, _pmesh(kind), mode,
                                    lambda: (H.hint_residual(t), H.hint_batch_only(t)))
        assert got == want, (shape, mode, kind)
        assert out[0] is t and out[1] is t
    # outside any context the hints do nothing
    t = torch.zeros(2, 8, 4)
    assert H.hint_residual(t) is t and H.hint_batch_only(t) is t


FAMILY_ARCHS = ["stablelm-1.6b", "granite-moe-3b-a800m", "mamba2-1.3b", "recurrentgemma-2b",
                "whisper-small", "internvl2-2b"]
B, S, S_ENC = 2, 16, 24


def _batch(cfg, labels: bool, rng):
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": tok}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("mode", ["sp", "fsdp2d"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_under_host_mesh(monkeypatch, arch, mode):
    import jax.numpy as jnp

    jcfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(5)
    nb = _batch(cfg, True, rng)
    japi, api = JF.get_family_api(jcfg), get_family_api(cfg)
    jparams = jax.eval_shape(lambda: japi["init"](jax.random.PRNGKey(0), jcfg))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jpre = {k: v for k, v in jb.items() if k != "labels"}
    want = _jax_hint_specs(monkeypatch, AbstractMesh((1, 1), ("data", "model")), mode, lambda: (
        jax.eval_shape(lambda p: japi["prefill"](p, jcfg, jpre, S + 8), jparams),
        jax.eval_shape(lambda p: japi["train_loss"](p, jcfg, jb), jparams)))

    params = api["init"](cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tpre = {k: v for k, v in tb.items() if k != "labels"}
    named = named_jax_params(params)

    def run():
        with torch.no_grad():
            logits, state = api["prefill"](params, cfg, tpre, S + 8)
        loss, _ = api["train_loss"](params, cfg, tb)
        grads = torch.autograd.grad(loss, list(named.values()))
        return logits, state, loss, grads

    plain = run()
    got, hinted = _port_hint_specs(monkeypatch, make_host_mesh(device="cpu"), mode, run)
    assert got == want, (arch, mode, sorted(got ^ want))
    assert got  # every family passes at least one hint site
    pairs = list(zip(jax.tree.leaves(plain), jax.tree.leaves(hinted), strict=True))
    assert len(pairs) > len(named)
    for a, b in pairs:
        assert torch.equal(a, b)
