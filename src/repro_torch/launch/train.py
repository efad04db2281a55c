"""Training driver of the port: pointnet2-cls, pointnet2-seg and the LMs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch pointnet2-cls --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch pointnet2-seg --smoke \\
        --steps 3 --device cpu --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --steps 50 --batch 8 --seq 128 --device cpu --ckpt-dir /tmp/ckpt

The JAX package's `launch/train.py`: config registry, seeded
restart-exact data, AdamW, async checkpoints in the reference's format,
the straggler monitor and (LMs) restart supervision.

Point clouds: the step is the reference's `step_fn`, the gradient of the
accelerator's `loss_fn` (`torch.autograd.grad`, the counterpart of
`jax.value_and_grad`), then `adamw_update`, which writes the parameters
and moments in place.  On the card the whole step is one captured CUDA
graph (`core/graphs.GraphedStep`), the counterpart of `jax.jit(step_fn)`:
its first call runs eagerly and captures, every later call replays; its
forward launches the port's kernels (FPS, lattice tiles, knn3 for seg, SC
matmul under a quant policy) and its backward is autograd's, since no
kernel of the path carries a gradient (the SC kernel's output is integer
work the reference's gradient flows around, through the two scales).

LMs (`train_lm`, every family): `train.make_train_step` on batches of
`data.tokens.token_stream`, drawn on the CPU by a prefetch thread and
moved to the card by the loop; the step runs eagerly (every linear on the
SC kernel under an SC policy).  encdec (whisper) and vlm (internvl2) get
the reference's zero stubs of their frontends' outputs, made on the
device in cfg.dtype: enc_embeds (batch, seq, d_model) and patch_embeds
(batch, n_patches, d_model).  Those zero patches overflow internvl2's
gradient at its 24 layers, in the reference as here: a zero row stays
zero, and each RMSNorm's backward scales its gradient by rsqrt(eps).
With --ckpt-dir, `run_with_restarts`
supervises the loop and the checkpoints hold the train state in the
reference's layout (`LMCheckpoints`).  With `--device cpu` either path
runs on the plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import graphs
from repro_torch.core.accelerator import PC2IMAccelerator, get_accelerator
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.data.pointclouds import fold_in, sample_batch
from repro_torch.data.tokens import Prefetcher, token_stream
from repro_torch.models.families import get_family_api
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.params import lm_state_from_tree, lm_state_to_tree, named_jax_params
from repro_torch.runtime.fault_tolerance import StragglerMonitor, run_with_restarts
from repro_torch.train.step import make_train_step

# the step's metrics: the loss's, then the optimizer's
METRICS = ("loss", "accuracy", "grad_norm")


def _policy_override(cfg, args) -> ExecutionPolicy:
    """Config default policy, with --quant applied on top when given."""
    policy = resolve_policy(cfg, None)
    if getattr(args, "quant", None):
        policy = dataclasses.replace(policy, quant=args.quant)
    return policy


def value_and_grad(accel: PC2IMAccelerator, params, points, labels) -> tuple:
    """((loss, metrics), grads) of `accel.loss_fn`, as `jax.value_and_grad(has_aux=True)`.

    grads is {reference name: tensor} over every parameter; the loss and
    metrics come back detached.
    """
    named = named_jax_params(params)
    loss, aux = accel.loss_fn(params, points, labels)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), grads


def train_step(accel: PC2IMAccelerator, params, state: AdamWState, points, labels, *,
               lr: float) -> tuple:
    """The reference's `step_fn`, eager: returns (params, state, metrics), the
    parameters and moments updated in place."""
    (_, aux), grads = value_and_grad(accel, params, points, labels)
    params, state, m = adamw_update(grads, state, params, lr=lr, weight_decay=1e-4)
    return params, state, {**aux, **m}


class TrainStep:
    """`train_step` bound to one (params, state): step(points, labels) -> metrics.

    On the card every call after the first replays one CUDA graph of the
    whole step (`core/graphs.GraphedStep`), points and labels being its
    static inputs; on the CPU, or inside `graphs.eager()`, it runs eagerly.
    The parameters and moments are updated in place either way.
    """

    def __init__(self, accel: PC2IMAccelerator, params, state: AdamWState, *, lr: float):
        self.accel, self.params, self.state, self.lr = accel, params, state, lr
        self._graph = (graphs.GraphedStep(self._fn, self._tensors, accel.device)
                       if accel.device.type == "cuda" else None)

    def _tensors(self) -> list:
        s = self.state
        return [*self.params.parameters(), *s.mu.values(), *s.nu.values(),
                *(s.master.values() if s.master is not None else ()), s.step]

    def _fn(self, points, labels) -> tuple:
        _, _, m = train_step(self.accel, self.params, self.state, points, labels, lr=self.lr)
        return tuple(m[k] for k in METRICS)

    def __call__(self, points, labels) -> dict:
        """One training step; returns {"loss", "accuracy", "grad_norm"} as device scalars."""
        if self._graph is None:
            out = self._fn(self.accel._points(points), self.accel._labels(labels))
        else:
            out = self._graph(points, labels)
        return dict(zip(METRICS, out))


def train_pointcloud(cfg, args):
    """Train a pointnet2 config for `args.steps` steps; returns the parameters."""
    # one accelerator = preprocessing engines + policy-driven feature path
    # (quant/backend from the config; --quant overrides without a new config)
    accel = get_accelerator(cfg, _policy_override(cfg, args), device=getattr(args, "device", None))
    params = accel.init(torch.Generator().manual_seed(args.seed))
    state = adamw_init(params)
    step = TrainStep(accel, params, state, lr=args.lr)

    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    mon = StragglerMonitor()
    t0 = time.time()
    for i in range(args.steps):
        pts, cls, seg = sample_batch(fold_in(args.seed, 10_000 + i), args.batch, cfg.n_points,
                                     device=accel.device)
        labels = cls if cfg.task == "cls" else seg
        mon.step_start()
        aux = step(pts, labels)
        dt = mon.step_end(i)
        if mgr:
            mgr.maybe_save(i + 1, {"params": params, "opt": state})
        if i % args.log_every == 0 or i == args.steps - 1:
            print(
                f"step {i}: loss={float(aux['loss']):.4f} acc={float(aux['accuracy']):.3f} "
                f"({dt*1e3:.0f}ms, {time.time()-t0:.0f}s)",
                flush=True,
            )
    if mgr:
        mgr.maybe_save(args.steps, {"params": params, "opt": state}, force=True)
        mgr.wait()
    return params


class LMCheckpoints(CheckpointManager):
    """A CheckpointManager for an LM train state {"params": DenseLM, "opt": AdamWState}:
    it writes and restores the reference's layout (`params.lm_state_to_tree`), and a
    restore copies into the state given (`params.lm_state_from_tree`).

    Both go through the host: a save stacks the layers there, and a restore
    reads the leaves there and copies each into the state's own tensor, so
    a state on the card gets no second copy on it."""

    def maybe_save(self, step: int, tree, *, force: bool = False, extra=None) -> bool:
        """Save the state's reference tree when `step` is a multiple of `every` (or `force`)."""
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()  # the save under way holds the previous host tree
        return super().maybe_save(step, lm_state_to_tree(tree, device="cpu"), force=True,
                                  extra=extra)

    def restore_or_none(self, tree_like, *, device=None):
        """(state restored in place, step, extra) from the newest checkpoint, or None.

        `device` is `run_with_restarts`' and goes unused: the state's own
        tensors say where each leaf goes."""
        out = super().restore_or_none(lm_state_to_tree(tree_like, device="meta"), device="cpu")
        if out is None:
            return None
        tree, step, extra = out
        return lm_state_from_tree(tree_like, tree), step, extra


def train_lm(cfg, args):
    """Train an LM config for `args.steps` steps; returns the final state
    {"params", "opt"}.  The reference's `train_lm`, on `args.device` (the card
    unless it names another)."""
    dev = resolve_device(getattr(args, "device", None))
    api = get_family_api(cfg)
    step_fn = make_train_step(
        cfg, peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, policy=_policy_override(cfg, args),
    )
    mgr = LMCheckpoints(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    mon = StragglerMonitor()

    def make_state():
        params = api["init"](cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
        return {"params": params, "opt": adamw_init(params)}

    stubs = {}  # the stubbed frontends' outputs, zeros as in the reference
    if cfg.family == "encdec":
        stubs["enc_embeds"] = torch.zeros((args.batch, args.seq, cfg.d_model), dtype=cfg.dtype,
                                          device=dev)
    if cfg.family == "vlm":
        stubs["patch_embeds"] = torch.zeros((args.batch, cfg.n_patches, cfg.d_model),
                                            dtype=cfg.dtype, device=dev)

    def loop(state, start_step):
        stream = Prefetcher(token_stream(args.seed, args.batch, args.seq, cfg.vocab_size,
                                         start_step=start_step, device="cpu"))
        t0 = time.time()
        params, opt = state["params"], state["opt"]
        try:
            for step, batch in stream:
                if step >= args.steps:
                    break
                batch = {k: v.to(dev) for k, v in batch.items()}
                batch.update(stubs)
                mon.step_start()
                params, opt, metrics = step_fn(params, opt, batch)
                dt = mon.step_end(step)
                if mgr:
                    mgr.maybe_save(step + 1, {"params": params, "opt": opt})
                if step % args.log_every == 0 or step == args.steps - 1:
                    print(
                        f"step {step}: loss={float(metrics['loss']):.4f} "
                        f"lr={float(metrics['lr']):.2e} ({dt*1e3:.0f}ms, {time.time()-t0:.0f}s)",
                        flush=True,
                    )
        finally:
            stream.close()
        return {"params": params, "opt": opt}, args.steps

    if mgr:
        state, last, _ = run_with_restarts(make_state, loop, ckpt_manager=mgr)
        mgr.maybe_save(last, state, force=True)
        mgr.wait()
    else:
        state, _ = loop(make_state(), 0)
    if mon.events:
        print(f"stragglers detected: {len(mon.events)}")
    return state


def main(argv=None):
    """Parse the reference's flags (plus --device) and train a pointnet2 or LM config."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default=None, choices=["none", "sc_w16a16", "sc_w8a8"],
                    help="override the config's quant mode (ExecutionPolicy)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="where to train: the card by default, 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.arch.startswith("pointnet2"):
        return train_pointcloud(cfg, args)
    return train_lm(cfg, args)


if __name__ == "__main__":
    main()
