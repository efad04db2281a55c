"""Training driver of the port: pointnet2-cls and pointnet2-seg on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch pointnet2-cls --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch pointnet2-seg --smoke \\
        --steps 3 --device cpu --ckpt-dir /tmp/ckpt

The JAX package's `launch/train.py` for the point-cloud models: config
registry, the seeded restart-exact batches of `data.pointclouds`, AdamW,
async checkpoints in the reference's format and the straggler monitor.
The step is the reference's `step_fn`: the gradient of the accelerator's
`loss_fn` (`torch.autograd.grad`, the counterpart of
`jax.value_and_grad`), then `adamw_update`, which writes the parameters
and moments in place.  On the card the whole step is one captured CUDA
graph (`core/graphs.GraphedStep`), the counterpart of `jax.jit(step_fn)`:
its first call runs eagerly and captures, every later call replays; its
forward launches the port's kernels (FPS, lattice tiles, knn3 for seg, SC
matmul under a quant policy) and its backward is autograd's, since no
kernel of the path carries a gradient (the SC kernel's output is integer
work the reference's gradient flows around, through the two scales).
With `--device cpu` it runs eagerly on the plain versions.

LM training (`--arch` other than pointnet2-*) waits for ROADMAP.md queue
A item 11, step 3f; the dense LMs already serve (`serve.make_serve_fns`).
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
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.data.pointclouds import fold_in, sample_batch
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.params import named_jax_params
from repro_torch.runtime.fault_tolerance import StragglerMonitor

NOT_PORTED_LM = ("--arch {arch!r}: LM training is not ported yet (ROADMAP.md, queue A item 11, "
                 "step 3f); the dense LMs serve (repro_torch.serve.make_serve_fns), and the port "
                 "trains pointnet2-cls and pointnet2-seg")
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


def main(argv=None):
    """Parse the reference's point-cloud flags (plus --device) and train.

    An LM --arch raises the not-ported error.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
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
    if not args.arch.startswith("pointnet2"):
        raise NotImplementedError(NOT_PORTED_LM.format(arch=args.arch))
    return train_pointcloud(get_config(args.arch, smoke=args.smoke), args)


if __name__ == "__main__":
    main()
