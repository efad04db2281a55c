"""Port parity, training: the loss, its gradients, AdamW, the schedule and the
training step of repro_torch against the JAX package, on the smoke configs.

The JAX side runs as its own tests run it on the CPU:
`ExecutionPolicy(backend="xla")`, the plain XLA path.  Parameters come from
the reference's `init_params`, bridged (`params.from_jax_params`); batches
from the reference's `sample_batch`, handed to both as numpy arrays.

Tolerances and why:
  * float loss atol 1e-5 and gradients within 1e-5 of each leaf's max |g|:
    torch's CPU matmuls and XLA's sum in different orders, and LayerNorm's
    variance is reduced in different orders (~1e-7 relative a layer);
  * SC loss atol 1e-3 (one 16-bit quantum of an activation can land on the
    other side of a rounding boundary, as in tests/test_torch_model.py;
    observed ~1.5e-5).  SC gradients reach a weight only through the two
    quantizer scales (round and the int32 cast cut the rest, in both
    packages), so most leaves have one nonzero, or one row.  Held: the
    same nonzero pattern above an absolute floor of 1e-30 (XLA's CPU
    backend flushes denormals to zero and torch does not, so the early
    layers' ~1e-39 values are zero in one and not the other; the floor is
    the chosen remedy, not torch.set_flush_denormal), and each value within
    1e-3 of the leaf's max where that max is at least 1e-3 (the last
    layers; observed <= 1.9e-4), 2e-2 below it (observed <= 9.7e-3 against
    the jitted reference, 1.05e-2 against its eager loss_fn): such a leaf's
    gradient passes through the amax of one or more later layers' inputs,
    a sum over a whole activation tensor in which the packages'
    one-quantum differences do not cancel as the values do (the
    reference's own jitted and eager SC losses differ by 1.4e-5);
  * AdamW, clipping and the schedule on identical inputs: rtol 1e-6, for
    the optimizer's leaves of each leaf's max |value| (the same float32
    formula, bitwise against the reference's eager update; its jitted
    update fuses the formula and rounds a few moments an ulp apart);
  * three training steps: each step's loss within 1e-4 (float) of the
    reference's jitted step_fn, 1e-3 under SC.  Parameters after several
    steps are not held elementwise: Adam turns a gradient of +-1e-9 into an
    update of about +-lr, so a sign flip of a near-zero gradient would
    move a weight by 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.base import get_config as j_get_config
from repro.core.accelerator import get_accelerator as j_get_accelerator
from repro.core.policy import ExecutionPolicy as JPolicy
from repro.data.pointclouds import sample_batch as j_sample_batch
from repro.models import nn as jnn
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_warmup_schedule as j_schedule
from repro_torch.configs import get_config
from repro_torch.core import graphs
from repro_torch.core.accelerator import get_accelerator
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.launch.train import TrainStep, train_step, value_and_grad
from repro_torch.models import nn as tnn
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup_schedule, global_norm)
from repro_torch.params import from_jax_params, to_jax_params, tree_leaves

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["pointnet2-cls", "pointnet2-seg"]
QUANTS = ["none", "sc_w16a16"]
BATCH = 2
LOSS_ATOL = {"none": 1e-5, "sc_w16a16": 1e-3}
FLOAT_GRAD_REL = 1e-5
SC_FLOOR = 1e-30
SC_GRAD_REL = 1e-3  # leaves whose max |g| >= SC_VALUE_SCALE
SC_VALUE_SCALE = 1e-3
SC_SCALE_PATH_REL = 2e-2  # leaves below it
OPT_RTOL = 1e-6
STEP_LOSS_ATOL = {"none": 1e-4, "sc_w16a16": 1e-3}


@pytest.fixture(scope="module")
def setups():
    """Per (arch, quant): the JAX accelerator and params, the port's, and two batches."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
        jp = j_get_accelerator(jcfg, JPolicy(backend="xla")).init(jax.random.PRNGKey(0))
        batches = []
        for seed in (1, 2, 3):
            pts, cls, seg = j_sample_batch(jax.random.PRNGKey(seed), BATCH, jcfg.n_points)
            batches.append((np.array(pts), np.array(cls if jcfg.task == "cls" else seg)))
        for q in QUANTS:
            out[arch, q] = dict(
                jaccel=j_get_accelerator(jcfg, JPolicy(quant=q, backend="xla")), jp=jp,
                taccel=get_accelerator(tcfg, ExecutionPolicy(quant=q), device="cpu"),
                tcfg=tcfg, batches=batches)
    return out


def _bridged(s):
    return from_jax_params(jax.tree.map(np.asarray, s["jp"]), s["tcfg"], device="cpu")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_loss_match_reference(setups, arch, quant):
    s = setups[arch, quant]
    tp = _bridged(s)
    pts, labels = s["batches"][0]
    jl, jm = jax.jit(s["jaccel"].loss_fn)(s["jp"], jnp.asarray(pts), jnp.asarray(labels))
    jl2, jm2 = s["jaccel"].loss(s["jp"], jnp.asarray(pts), jnp.asarray(labels))
    for tl, tm in (s["taccel"].loss_fn(tp, pts, labels), s["taccel"].loss(tp, pts, labels)):
        assert tl.shape == () and tm["loss"] is tl
        for want in (jl, jl2):  # the reference's eager loss_fn and jitted loss
            np.testing.assert_allclose(float(tl.detach()), float(want), rtol=0,
                                       atol=LOSS_ATOL[quant])
        assert float(tm["accuracy"]) == float(jm["accuracy"]) == float(jm2["accuracy"])
    assert s["taccel"].loss_fn(tp, pts, labels)[0].requires_grad
    assert not s["taccel"].loss(tp, pts, labels)[0].requires_grad


def test_accuracy_ties_go_to_the_first_index():
    """loss_fn's accuracy takes argmax, whose ties go to the first index in both packages."""
    logits = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]])
    assert torch.equal(logits.argmax(-1), torch.tensor([1, 0]))
    assert np.array_equal(np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)), [1, 0])


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(setups, arch, quant):
    s = setups[arch, quant]
    tp = _bridged(s)
    pts, labels = s["batches"][0]
    (jl, _), jg = jax.jit(jax.value_and_grad(s["jaccel"].loss_fn, has_aux=True))(
        s["jp"], jnp.asarray(pts), jnp.asarray(labels))
    (tl, _), tg = value_and_grad(s["taccel"], tp, pts, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=LOSS_ATOL[quant])
    want, got = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(want) == len(got) == len(list(tp.parameters()))
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape
        top = float(np.abs(w).max())
        if quant == "none":
            assert np.abs(g - w).max() <= FLOAT_GRAD_REL * top, f"leaf {i}"
            continue
        np.testing.assert_array_equal(np.abs(g) > SC_FLOOR, np.abs(w) > SC_FLOOR,
                                      err_msg=f"leaf {i}: nonzero pattern")
        if top > SC_FLOOR:
            rel = SC_GRAD_REL if top >= SC_VALUE_SCALE else SC_SCALE_PATH_REL
            assert np.abs(g - w).max() <= rel * top, f"leaf {i}: {np.abs(g - w).max() / top}"


def test_sc_gradient_reaches_weights_only_through_the_scales(setups):
    """The head's last weight gets one nonzero, at its max |w|, in both packages."""
    s = setups["pointnet2-cls", "sc_w16a16"]
    tp = _bridged(s)
    pts, labels = s["batches"][0]
    _, tg = value_and_grad(s["taccel"], tp, pts, labels)
    g = tg["head.layers.1.lin.w"]
    w = tp.head.layers[1].lin.w.detach()
    assert int((g != 0).sum()) == 1
    assert int(g.abs().flatten().argmax()) == int(w.abs().flatten().argmax())


def _numpy_grads(tree, rng, scale):
    return [(rng.standard_normal(np.shape(x)) * scale).astype(np.float32)
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference_on_the_model_tree(setups, scale):
    s = setups["pointnet2-seg", "none"]
    jp, tp = s["jp"], _bridged(s)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    assert ts.master is None and js.master is None
    rng = np.random.default_rng(0)
    treedef = jax.tree.structure(jp)
    names = list(ts.mu)  # the reference's names, in the module's order
    order = [n for _, n in sorted((p, n) for n, p in zip(names, _paths(names)))]
    j_update = jax.jit(lambda g, st, p: j_adamw_update(g, st, p, lr=1e-3, weight_decay=1e-4))
    for step in range(3):
        flat = _numpy_grads(jp, rng, scale)
        jgrads = jax.tree.unflatten(treedef, [jnp.asarray(g) for g in flat])
        tgrads = {n: torch.from_numpy(g) for n, g in zip(order, flat)}
        jp, js, jm = j_update(jgrads, js, jp)
        out, ts, tm = adamw_update(tgrads, ts, tp, lr=1e-3, weight_decay=1e-4)
        assert out is tp
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=OPT_RTOL)
        assert int(ts.step) == int(js.step) == step + 1 and ts.step.dtype == torch.int32
        pairs = [*zip(jax.tree.leaves(jp), jax.tree.leaves(to_jax_params(tp))),
                 *zip(jax.tree.leaves((js.mu, js.nu)), tree_leaves((ts.mu, ts.nu)))]
        for i, (w, g) in enumerate(pairs):
            w, g = np.asarray(w), np.asarray(g)
            assert np.abs(g - w).max() <= OPT_RTOL * np.abs(w).max(), f"step {step} leaf {i}"
    if scale > 1:
        assert float(jm["grad_norm"]) > 1.0  # clipping was engaged


def _paths(names):
    return [tuple(int(c) if c.isdigit() else c for c in n.split(".")) for n in names]


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 3,
            "b": rng.standard_normal((5,)).astype(np.float32)}
    from repro.optim.adamw import clip_by_global_norm as j_clip
    from repro.optim.adamw import global_norm as j_norm

    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jtree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(global_norm(ttree)), float(j_norm(jtree)), rtol=OPT_RTOL)
    for max_norm in (0.5, 1e6):
        (tc, tn), (jc, jn) = clip_by_global_norm(ttree, max_norm), j_clip(jtree, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=OPT_RTOL)
    assert float(global_norm(clip_by_global_norm(ttree, 0.5)[0])) == pytest.approx(0.5, rel=1e-5)


def test_bf16_params_keep_fp32_master_weights():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state.master is not None and state.master["w"].dtype == torch.float32
    grads = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    new, state, _ = adamw_update(grads, state, params, lr=1e-4)
    assert new["w"].dtype == torch.bfloat16 and state.master["w"].dtype == torch.float32
    assert bool((state.master["w"] < 1.0).all())  # the master moved below bf16's resolution
    jstate = j_adamw_init({"w": jnp.ones((4,), jnp.bfloat16)})
    _, jstate, _ = j_adamw_update({"w": jnp.full((4,), 1e-3, jnp.bfloat16)}, jstate,
                                  {"w": jnp.ones((4,), jnp.bfloat16)}, lr=1e-4)
    np.testing.assert_allclose(state.master["w"].numpy(), np.asarray(jstate.master["w"]),
                               rtol=OPT_RTOL)


def test_schedule_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    got = cosine_warmup_schedule(torch.tensor(steps), **kw).numpy()
    want = np.asarray(j_schedule(jnp.asarray(steps), **kw))
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL)
    assert float(cosine_warmup_schedule(10, **kw)) == pytest.approx(3e-4, rel=1e-6)


def test_count_params_matches_reference(setups):
    for arch in ARCHS:
        s = setups[arch, "none"]
        tp = _bridged(s)
        assert tnn.count_params(tp) == jnn.count_params(s["jp"]) > 0
        assert tnn.count_params(to_jax_params(tp)) == jnn.count_params(s["jp"])


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference_step_fn(setups, arch, quant):
    s = setups[arch, quant]
    jaccel, lr = s["jaccel"], 1e-3

    @jax.jit
    def step_fn(params, state, pts, labels):  # launch/train.py:49-56
        (loss, aux), grads = jax.value_and_grad(jaccel.loss_fn, has_aux=True)(params, pts, labels)
        params, state, m = j_adamw_update(grads, state, params, lr=lr, weight_decay=1e-4)
        return params, state, {**aux, **m}

    jp, js = s["jp"], j_adamw_init(s["jp"])
    tp = _bridged(s)
    step = TrainStep(s["taccel"], tp, adamw_init(tp), lr=lr)
    for pts, labels in s["batches"]:
        jp, js, jm = step_fn(jp, js, jnp.asarray(pts), jnp.asarray(labels))
        tm = step(pts, labels)
        assert set(tm) == {"loss", "accuracy", "grad_norm"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0,
                                   atol=STEP_LOSS_ATOL[quant])
    assert int(step.state.step) == int(js.step) == 3


# -- the step's capture, without a card ---------------------------------------------


class _StubGraph:
    def __init__(self, fn, static, outputs):
        self.fn, self.static, self.outputs = fn, static, outputs

    def replay(self):  # a real replay runs no Python, so inference mode does not reach it
        with torch.inference_mode(False):
            new = self.fn(*self.static)
        for dst, src in zip(self.outputs, new):
            dst.copy_(src)


def _stub_capture_for(state):
    """A capture that runs nothing, as a real one: fn runs once to learn its
    outputs, and every state tensor is put back as it was."""

    def capture(fn, static, what):
        saved = [t.detach().clone() for t in state()]
        outputs = tuple(o.detach().clone() for o in fn(*static))
        with torch.no_grad():
            for t, v in zip(state(), saved):
                t.copy_(v)
        return _StubGraph(fn, static, outputs), outputs, {}
    return capture


@pytest.mark.parametrize("quant", QUANTS)
def test_graphed_step_replays_equal_eager_steps(setups, quant):
    """GraphedStep's first call is the eager step and its capture runs
    nothing, so replayed steps equal eager steps bitwise (here with a stub)."""
    s = setups["pointnet2-cls", quant]
    eager_p, graph_p = _bridged(s), _bridged(s)
    eager = TrainStep(s["taccel"], eager_p, adamw_init(eager_p), lr=1e-3)
    graphed = TrainStep(s["taccel"], graph_p, adamw_init(graph_p), lr=1e-3)
    graphed._graph = graphs.GraphedStep(graphed._fn, graphed._tensors, torch.device("cpu"),
                                        _stub_capture_for(graphed._tensors))
    before = graphs.captures()
    for pts, labels in s["batches"] * 2:
        want = eager(pts, labels)
        got = graphed(torch.from_numpy(pts), torch.from_numpy(labels))
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert graphs.captures() - before == 1
    for a, b in zip(eager._tensors(), graphed._tensors()):
        assert torch.equal(a, b)
    # a parameter given new storage (a restore by replacement) captures again
    graph_p.head.layers[0].lin.b.data = graph_p.head.layers[0].lin.b.detach().clone()
    eager_p.head.layers[0].lin.b.data = eager_p.head.layers[0].lin.b.detach().clone()
    pts, labels = s["batches"][0]
    assert torch.equal(graphed(pts, labels)["loss"], eager(pts, labels)["loss"])
    assert graphs.captures() - before == 2
    with graphs.eager():  # eager() runs the step op by op, capturing nothing
        graphed(pts, labels)
    assert graphs.captures() - before == 2


class _HostDataCheck(TorchFunctionMode):
    """Records every call that builds a tensor from host data or reads one back."""

    FORBIDDEN = {"tensor", "item", "tolist", "cpu", "numpy", "nonzero", "argwhere",
                 "masked_select", "unique", "__bool__", "__int__", "__float__"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        host_in = name in ("as_tensor", "asarray") and not isinstance(args[0], torch.Tensor)
        if name in self.FORBIDDEN or host_in:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_takes_no_host_data(setups, arch, quant):
    """What the step's capture records, forward, gradient and update, builds no
    tensor from host data and reads nothing back (here on the plain versions)."""
    s = setups[arch, quant]
    tp = _bridged(s)
    state = adamw_init(tp)
    pts, labels = (torch.from_numpy(x) for x in s["batches"][0])
    check = _HostDataCheck()
    with check:
        _, _, m = train_step(s["taccel"], tp, state, pts, labels.to(torch.int64), lr=1e-3)
    assert check.seen == []
    assert all(bool(torch.isfinite(v)) for v in m.values())
