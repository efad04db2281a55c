"""Port parity, checkpoints: repro_torch.checkpoint writes and reads the JAX
package's format, and `python -m repro_torch.launch.train` leaves checkpoints
the JAX package reads.

Every comparison is bitwise: a checkpoint stores raw bytes, so a tree
written by one package and read by the other must come back bit for bit,
in the reference's leaf order (`jax.tree_util.tree_flatten`).  The
substrate properties mirror `TestCheckpoint` in tests/test_substrate.py:
round trip with float32, int32 and bfloat16 leaves, the async save,
atomicity (an incomplete step is ignored), and keep/every garbage
collection.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.base import get_config as j_get_config
from repro.models import pointnet2 as JPN
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch.train import train_lm
from repro_torch.models.pointnet2 import PointNet2Params
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.params import from_jax_params, to_jax_params, tree_leaves

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu() if isinstance(b, torch.Tensor) else b
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        a = a.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    if isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16:
        b = b.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module", params=["pointnet2-cls", "pointnet2-seg"])
def trained(request):
    """A {"params", "opt"} tree after one update, in both packages, from the same values."""
    arch = request.param
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = JPN.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)),
                         jp)
    jp1, js1, _ = j_adamw_update(grads, j_adamw_init(jp), jp, lr=1e-3)
    jtree = {"params": jp1, "opt": js1}
    tp = from_jax_params(jax.tree.map(np.asarray, jp1), tcfg, device="cpu")
    state = adamw_init(tp)
    mu, nu = ({k: torch.from_numpy(np.array(v)) for k, v in zip(_names(state.mu), jax.tree.leaves(m))}
              for m in (js1.mu, js1.nu))
    ttree = {"params": tp, "opt": AdamWState(torch.tensor(int(js1.step), dtype=torch.int32),
                                             mu, nu, None)}
    return arch, jtree, ttree, jp, tcfg


def _names(named: dict) -> list:
    """The dict's names in the reference's leaf order."""
    def path(n):
        return tuple(int(c) if c.isdigit() else c for c in n.split("."))
    return sorted(named, key=path)


def test_the_two_trees_hold_the_same_leaves(trained):
    _, jtree, ttree, _, _ = trained
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    assert all(_same(a, b) for a, b in zip(jl, tl))


def test_jax_written_checkpoint_loads_into_the_port_bitwise(trained, tmp_path):
    _, jtree, _, _, tcfg = trained
    j_save(str(tmp_path), 5, jtree, extra={"who": "jax"})
    like_p = PointNet2Params(tcfg, device="cpu")
    like = {"params": like_p, "opt": adamw_init(like_p)}
    tree, step, extra = load_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 5 and extra == {"who": "jax"}
    assert isinstance(tree["params"], PointNet2Params) and tree["params"] is not like_p
    assert isinstance(tree["opt"], AdamWState) and tree["opt"].master is None
    assert tree["opt"].step.dtype == torch.int32 and int(tree["opt"].step) == 1
    assert all(_same(a, b) for a, b in zip(jax.tree.leaves(jtree), tree_leaves(tree)))
    assert set(tree["opt"].mu) == set(like["opt"].mu)
    # the restored module runs: its parameters are the checkpoint's
    assert all(_same(a, b) for a, b in zip(jax.tree.leaves(jtree["params"]),
                                           jax.tree.leaves(to_jax_params(tree["params"]))))


def test_port_written_checkpoint_loads_in_jax_bitwise(trained, tmp_path):
    _, jtree, ttree, jp, _ = trained
    save_checkpoint(str(tmp_path), 9, ttree, extra={"who": "port"})
    like = {"params": jp, "opt": j_adamw_init(jp)}
    tree, step, extra = j_load(str(tmp_path), like)
    assert step == 9 and extra == {"who": "port"}
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    assert all(_same(a, b) for a, b in zip(jax.tree.leaves(tree), tree_leaves(ttree)))


def test_both_packages_write_the_same_bytes(trained, tmp_path):
    _, jtree, ttree, _, _ = trained
    j_save(str(tmp_path / "jax"), 3, jtree)
    save_checkpoint(str(tmp_path / "port"), 3, ttree)
    blobs = [(tmp_path / who / "step_000000000003" / "data.msgpack.zst").read_bytes()
             for who in ("jax", "port")]
    assert blobs[0] == blobs[1]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.ones(3, dtype=torch.bfloat16) * 1.5}}


def test_roundtrip_float_int_and_bfloat16(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    out, step, _ = load_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 7
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference reads the bfloat16 record too
    jlike = {"a": jnp.zeros((8, 4)), "b": {"c": jnp.zeros(5, jnp.int32),
                                           "d": jnp.zeros(3, jnp.bfloat16)}}
    jout, _, _ = j_load(str(tmp_path), jlike)
    assert all(_same(a, b) for a, b in zip(jax.tree.leaves(jout), tree_leaves(t)))


def test_async_save_snapshots_before_returning(tmp_path):
    t = _tree()
    want = t["a"].clone()
    th = save_checkpoint(str(tmp_path), 3, t, blocking=False)
    t["a"].add_(1.0)  # the caller goes on updating in place
    th.join(timeout=60)
    assert not th.is_alive() and latest_step(str(tmp_path)) == 3
    out, _, _ = load_checkpoint(str(tmp_path), t, device="cpu")
    assert torch.equal(out["a"], want)


def test_atomicity_ignores_incomplete(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    # a crashed save: a step directory without the COMPLETE marker, and a tmp one
    os.makedirs(tmp_path / "step_000000000009")
    (tmp_path / "step_000000000009" / "data.msgpack.zst").write_bytes(b"junk")
    os.makedirs(tmp_path / "step_000000000011.tmp-abcd1234")
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), t)


def test_load_refuses_another_tree(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path), {"a": torch.zeros(1)})


def test_manager_gc_and_every(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=10)
    t = _tree()
    for s in [10, 20, 30]:
        assert mgr.maybe_save(s, t)
    assert not mgr.maybe_save(35, t)
    assert mgr.maybe_save(35, t, force=True)
    mgr.wait()
    mgr._gc()
    assert latest_step(str(tmp_path)) == 35
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_000000000030", "step_000000000035"]  # keep=2
    restored, step, _ = mgr.restore_or_none(t, device="cpu")
    assert step == 35 and torch.equal(restored["a"], t["a"])
    assert CheckpointManager(str(tmp_path / "new")).restore_or_none(t) is None


def test_load_places_tensors_on_the_named_device(tmp_path):
    p = PointNet2Params(get_config("pointnet2-cls", smoke=True), device="cpu")
    save_checkpoint(str(tmp_path), 2, {"params": p})
    out, _, _ = load_checkpoint(str(tmp_path), {"params": p}, device="cpu")
    assert all(q.device.type == "cpu" for q in out["params"].parameters())
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), out["params"].parameters()))


def test_load_defaults_to_the_card(tmp_path):
    """Like every entry point of the port, a restore lands on the card unless
    the caller names another device; a host without one says how to ask."""
    save_checkpoint(str(tmp_path), 1, _tree())
    if torch.cuda.is_available():
        out, _, _ = load_checkpoint(str(tmp_path), _tree())
        assert all(t.device.type == "cuda" for t in tree_leaves(out))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_checkpoint(str(tmp_path), _tree())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CheckpointManager(str(tmp_path)).restore_or_none(_tree())


def test_train_entry_point_leaves_a_checkpoint_jax_reads(tmp_path):
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "pointnet2-cls", "--smoke",
         "--steps", "3", "--device", "cpu", "--ckpt-dir", str(ckpt)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 2"]
    assert latest_step(str(ckpt)) == 3
    jp = JPN.init_params(jax.random.PRNGKey(0), j_get_config("pointnet2-cls", smoke=True))
    tree, step, _ = j_load(str(ckpt), {"params": jp, "opt": j_adamw_init(jp)})
    assert step == 3 and int(tree["opt"].step) == 3
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(tree))
    # the port reads it back too, and three steps moved the weights off their init
    like = PointNet2Params(get_config("pointnet2-cls", smoke=True), device="cpu")
    mine, _, _ = load_checkpoint(str(ckpt), {"params": like, "opt": adamw_init(like)},
                              device="cpu")
    init = PointNet2Params(get_config("pointnet2-cls", smoke=True),
                           generator=torch.Generator().manual_seed(0), device="cpu")
    assert not torch.equal(mine["params"].head.layers[0].lin.w, init.head.layers[0].lin.w)
    assert all(_same(a, b) for a, b in zip(jax.tree.leaves(tree), tree_leaves(mine)))


def test_an_lm_arch_raises_not_ported():
    """The name predates the encdec family's port: an encdec LM (whisper smoke) now
    trains a step through train_lm, fed the reference's zero encoder stubs, and an
    LM of a family no package knows raises before any step."""
    args = argparse.Namespace(steps=1, batch=2, seq=16, lr=1e-3, seed=0, quant=None,
                              ckpt_dir=None, ckpt_every=50, log_every=1, device="cpu")
    cfg = get_config("whisper-small", smoke=True)
    state = train_lm(cfg, args)
    assert state["params"].cfg is cfg and int(state["opt"].step) == 1
    assert all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())
    bad = dataclasses.replace(get_config("stablelm-1.6b", smoke=True), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        train_lm(bad, args)


def test_adamw_state_saved_mid_training_resumes_bitwise(tmp_path):
    """Saving {"params", "opt"}, restoring into fresh objects and stepping on
    gives what stepping on without the round trip gives."""
    p = PointNet2Params(get_config("pointnet2-cls", smoke=True),
                        generator=torch.Generator().manual_seed(1), device="cpu")
    state = adamw_init(p)
    rng = np.random.default_rng(2)

    def grads():
        return {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
                for k, v in state.mu.items()}

    adamw_update(grads(), state, p, lr=1e-3)
    save_checkpoint(str(tmp_path), 1, {"params": p, "opt": state})
    restored, _, _ = load_checkpoint(str(tmp_path), {"params": p, "opt": state}, device="cpu")
    g = grads()
    adamw_update(g, state, p, lr=1e-3)
    adamw_update(g, restored["opt"], restored["params"], lr=1e-3)
    for a, b in zip(tree_leaves({"params": p, "opt": state}), tree_leaves(restored)):
        assert torch.equal(a, b)
