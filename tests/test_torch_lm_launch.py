"""Port parity, the LM training entry point: the token stream, the prefetch thread,
restart supervision, checkpoints of the LM train state, and
`python -m repro_torch.launch.train` on a dense smoke config.

Bitwise throughout: the Markov recurrence fed the JAX package's own draws
gives the reference's tokens and labels; a checkpoint stores raw bytes, so
the train state written by either package must restore in the other bit for
bit, and the port's file must be the reference's, byte for byte; a run that
restarts from its checkpoints replays the same batches and steps, so it
ends where an uninterrupted run ends.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.data import tokens as JD
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.tokens import Prefetcher, markov_tokens, synth_batch, token_stream
from repro_torch.launch.train import LMCheckpoints, main, train_lm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.params import _leaf_to_torch, lm_state_from_tree, lm_state_to_tree, tree_leaves
from repro_torch.runtime.fault_tolerance import run_with_restarts
from repro_torch.train import make_train_step

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke shapes gain nothing from intra-op threads, and the suite runs several
    workers on the host's cores: one torch thread a test keeps them from
    oversubscribing (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "stablelm-1.6b"


def _same(a, b) -> bool:
    """Bitwise equal: dtype, shape and bytes (bf16 compared as 16-bit words)."""
    a = a if isinstance(a, torch.Tensor) else _leaf_to_torch(np.asarray(a))
    b = b if isinstance(b, torch.Tensor) else _leaf_to_torch(np.asarray(b))
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("vocab", [256, 100352])
def test_markov_tokens_fed_the_references_draws_give_its_batch(vocab):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    k1, k2, k3 = jax.random.split(key, 3)  # synth_batch's draws, as it makes them
    a = jax.random.randint(k1, (4, 1), 1, 8)
    x0 = jax.random.randint(k2, (4, 1), 0, vocab)
    noise = jax.random.randint(k3, (4, 64), 0, 3)
    want = JD.synth_batch(key, 4, 64, vocab)
    got = markov_tokens(*(torch.from_numpy(np.array(x)) for x in (a, x0, noise)), vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_synth_batch_draws_in_the_references_ranges():
    batch = synth_batch(torch.Generator().manual_seed(0), 64, 32, 97, device="cpu")
    toks, labels = batch["tokens"], batch["labels"]
    assert toks.shape == labels.shape == (64, 32) and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < 97)).all())
    assert torch.equal(labels[:, :-1], toks[:, 1:]) and torch.equal(labels[:, -1], toks[:, 0])
    # each row is one chain x_{t+1} = (a x_t + 7 + n_t) % 97, a in [1, 8), n_t in [0, 3)
    a = torch.arange(1, 8)[:, None, None]
    rest = (toks[None, :, 1:].long() - a * toks[None, :, :-1].long() - 7) % 97
    assert bool((rest < 3).all(dim=-1).any(dim=0).all())
    if torch.cuda.is_available():
        assert synth_batch(0, 2, 8, 97)["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            synth_batch(0, 2, 8, 97)


def test_token_stream_is_restart_exact_and_its_shards_differ():
    full = [b for _, b in zip(range(6), token_stream(5, 2, 16, 256, device="cpu"))]
    resumed = [b for _, b in zip(range(3), token_stream(5, 2, 16, 256, start_step=3,
                                                        device="cpu"))]
    assert [s for s, _ in full] == list(range(6)) and [s for s, _ in resumed] == [3, 4, 5]
    for (_, a), (_, b) in zip(full[3:], resumed):
        assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(full[0][1]["tokens"], full[1][1]["tokens"])
    other = next(token_stream(5, 2, 16, 256, shard_id=1, device="cpu"))[1]
    assert not torch.equal(other["tokens"], full[0][1]["tokens"])


def test_prefetcher_yields_the_stream_in_order_and_stops():
    stream = Prefetcher(iter(range(10)), depth=2)
    assert list(stream) == list(range(10))
    infinite = Prefetcher(token_stream(1, 2, 8, 64, device="cpu"))
    steps = [step for step, _ in zip(range(4), (s for s, _ in infinite))]
    assert steps == [0, 1, 2, 3]
    infinite.close()
    assert not infinite._thread.is_alive()

    def broken():
        yield 1
        raise ValueError("stream failed")

    failing = Prefetcher(broken())
    assert next(failing) == 1
    with pytest.raises(ValueError, match="stream failed"):
        next(failing)


def _state(cfg, seed=0):
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return {"params": params, "opt": adamw_init(params)}


def test_run_with_restarts_resumes_and_ends_as_an_uninterrupted_run(tmp_path):
    cfg = get_config(NAME, smoke=True)
    step_fn = make_train_step(cfg, peak_lr=1e-3, warmup_steps=2, total_steps=20)
    n_steps = 8

    def make_loop(mgr, fail_at):
        failures = []

        def loop(state, start_step):
            for step, batch in token_stream(1, 4, 32, cfg.vocab_size, start_step=start_step,
                                            device="cpu"):
                if step >= n_steps:
                    break
                if step == fail_at and not failures:
                    failures.append(step)
                    raise RuntimeError("simulated preemption")
                step_fn(state["params"], state["opt"], batch)
                mgr.maybe_save(step + 1, state)
            return state, n_steps
        return loop

    runs = {}
    for label, fail_at in (("uninterrupted", None), ("preempted", 5)):
        mgr = LMCheckpoints(str(tmp_path / label), every=2)
        runs[label] = run_with_restarts(lambda: _state(cfg), make_loop(mgr, fail_at),
                                        ckpt_manager=mgr, restore_device="cpu")
    (full, last_a, restarts_a), (resumed, last_b, restarts_b) = runs.values()
    assert (last_a, restarts_a, last_b, restarts_b) == (n_steps, 0, n_steps, 1)
    assert int(resumed["opt"].step) == n_steps
    assert all(_same(a, b) for a, b in zip(tree_leaves(lm_state_to_tree(full)),
                                          tree_leaves(lm_state_to_tree(resumed))))

    def always_fails(state, start_step):
        raise RuntimeError("lost the device")

    with pytest.raises(RuntimeError, match="lost the device"):
        run_with_restarts(lambda: _state(cfg), always_fails, max_restarts=2,
                          ckpt_manager=LMCheckpoints(str(tmp_path / "dead")),
                          restore_device="cpu")


@pytest.fixture(scope="module")
def bf16_states():
    """The reference's bf16 smoke train state after one update, and the port's,
    filled from it through lm_state_from_tree."""
    jcfg = dataclasses.replace(j_get_config(NAME, smoke=True), dtype_str="bfloat16")
    cfg = dataclasses.replace(get_config(NAME, smoke=True), dtype_str="bfloat16")
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jp)
    jp1, js1, _ = j_adamw_update(grads, j_adamw_init(jp), jp, lr=1e-3)
    jtree = {"params": jp1, "opt": js1}
    state = _state(cfg, seed=9)
    lm_state_from_tree(state, jax.tree.map(lambda x: _leaf_to_torch(np.asarray(x)), jtree))
    return jtree, state, cfg, jp


def test_lm_state_tree_holds_the_references_leaves(bf16_states):
    jtree, state, _, _ = bf16_states
    assert state["opt"].master is not None and int(state["opt"].step) == 1
    want, got = jax.tree.leaves(jtree), tree_leaves(lm_state_to_tree(state))
    assert len(want) == len(got)
    assert all(_same(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="does not match"):
        bad = lm_state_to_tree(state)
        bad["params"]["embed"] = bad["params"]["embed"].float()
        lm_state_from_tree(state, bad)


def test_lm_checkpoint_is_the_references_byte_for_byte(bf16_states, tmp_path):
    jtree, state, _, _ = bf16_states
    j_save(str(tmp_path / "jax"), 3, jtree)
    save_checkpoint(str(tmp_path / "port"), 3, lm_state_to_tree(state))
    blobs = [(tmp_path / who / "step_000000000003" / "data.msgpack.zst").read_bytes()
             for who in ("jax", "port")]
    assert blobs[0] == blobs[1]


def test_each_package_restores_the_others_lm_checkpoint(bf16_states, tmp_path):
    jtree, state, cfg, jp = bf16_states
    j_save(str(tmp_path / "jax"), 4, jtree, extra={"who": "jax"})
    fresh = _state(cfg, seed=11)
    restored, step, extra = LMCheckpoints(str(tmp_path / "jax")).restore_or_none(fresh,
                                                                                 device="cpu")
    assert restored is fresh and step == 4 and extra == {"who": "jax"}
    assert all(_same(g, w) for g, w in zip(tree_leaves(lm_state_to_tree(fresh)),
                                          jax.tree.leaves(jtree)))
    mgr = LMCheckpoints(str(tmp_path / "port"), every=5)
    assert not mgr.maybe_save(4, state) and mgr.maybe_save(5, state)
    mgr.wait()
    back, step, _ = j_load(str(tmp_path / "port"), {"params": jp, "opt": j_adamw_init(jp)})
    assert step == 5
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    assert all(_same(g, w) for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)))


def test_lm_checkpoints_go_through_the_host(monkeypatch, tmp_path):
    """LMCheckpoints saves a tree whose stacked leaves lie on the host, restores
    from a template of meta tensors (structure only) read onto the host, and
    copies each leaf into the state's own tensors."""
    from repro_torch.checkpoint import store

    seen = {}
    real_save, real_load = store.save_checkpoint, store.load_checkpoint

    def save(directory, step, tree, **kw):
        seen["saved"] = {t.device.type for t in tree_leaves(tree)}
        return real_save(directory, step, tree, **kw)

    def load(directory, tree_like, **kw):
        seen["template"] = {t.device.type for t in tree_leaves(tree_like)}
        seen["device"] = kw["device"]
        return real_load(directory, tree_like, **kw)

    monkeypatch.setattr(store, "save_checkpoint", save)
    monkeypatch.setattr(store, "load_checkpoint", load)
    cfg = get_config(NAME, smoke=True)
    saved, fresh = _state(cfg, seed=0), _state(cfg, seed=1)
    before = {n: p.data_ptr() for n, p in fresh["params"].named_parameters()}
    mgr = LMCheckpoints(str(tmp_path), every=1)
    assert mgr.maybe_save(1, saved)
    mgr.wait()
    restored, step, _ = mgr.restore_or_none(fresh)
    assert restored is fresh and step == 1
    assert seen == {"saved": {"cpu"}, "template": {"meta"}, "device": "cpu"}
    assert {n: p.data_ptr() for n, p in fresh["params"].named_parameters()} == before
    assert all(_same(a, b) for a, b in zip(tree_leaves(lm_state_to_tree(saved)),
                                          tree_leaves(lm_state_to_tree(fresh))))


def test_train_entry_point_trains_an_lm_and_leaves_a_checkpoint_jax_reads(tmp_path):
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", NAME, "--smoke",
           "--steps", "3", "--device", "cpu", "--ckpt-dir", str(ckpt)]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 2"]
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0])) for ln in lines)
    assert latest_step(str(ckpt)) == 3
    jcfg = j_get_config(NAME, smoke=True)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree, step, _ = j_load(str(ckpt), {"params": jp, "opt": j_adamw_init(jp)})
    assert step == 3 and int(tree["opt"].step) == 3 and tree["opt"].master is None
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(tree))


def test_train_lm_resumes_from_its_checkpoints(tmp_path, capsys):
    """train_lm with --ckpt-dir: a second run of 5 steps restores the first run's
    step-3 state and takes 2 more; the steps it logs start at 3."""
    cfg = get_config(NAME, smoke=True)
    args = argparse.Namespace(steps=3, batch=2, seq=16, lr=1e-3, seed=0, quant=None,
                              ckpt_dir=str(tmp_path), ckpt_every=50, log_every=1, device="cpu")
    first = train_lm(cfg, args)
    assert int(first["opt"].step) == 3 and latest_step(str(tmp_path)) == 3
    capsys.readouterr()
    second = train_lm(cfg, argparse.Namespace(**{**vars(args), "steps": 5}))
    logged = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("step ")]
    assert logged == ["step 3", "step 4"] and int(second["opt"].step) == 5
    assert latest_step(str(tmp_path)) == 5


def test_train_runs_on_the_card_unless_told_otherwise():
    argv = ["--arch", NAME, "--smoke", "--steps", "1", "--batch", "2", "--seq", "16"]
    if torch.cuda.is_available():
        t0 = time.time()
        state = main(argv)
        assert state["params"].embed.is_cuda and time.time() - t0 < 600
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
