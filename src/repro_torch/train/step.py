"""Train step factory: loss -> gradients -> AdamW, with optional gradient
accumulation over microbatches.

The JAX package's `train/step.py`.  The gradient is `torch.autograd.grad`
of the family's `train_loss` over every parameter under its reference name
(`params.named_jax_params`), the counterpart of `jax.value_and_grad`;
microbatching replaces the reference's `scan` by a loop in the same order.
`adamw_update` writes the parameters and the optimizer state in place
(`optim/adamw.py` says why), so the step returns the objects it was given.
Nothing in the step reads a value back to the host: the loss, the gradient
norm and the learning rate come back as device scalars.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.models.families import get_family_api
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import cosine_warmup_schedule
from repro_torch.params import named_jax_params


def make_train_step(
    cfg: ModelConfig,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    microbatch: int | None = None,
    b1: float = 0.9,
    b2: float = 0.95,
    policy: ExecutionPolicy | None = None,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    microbatch: split the batch into `microbatch` sequential chunks and sum
    their float32 gradients (then divide by `microbatch`), a memory knob.
    policy: the ExecutionPolicy of every linear of the step (None -> the
    config's default).  batch leaves are tensors on the parameters' device;
    metrics are {"loss", "grad_norm", "lr"}.
    """
    api = get_family_api(cfg)
    policy = resolve_policy(cfg, policy)

    def loss_and_grads(params, batch) -> tuple[torch.Tensor, dict]:
        named = named_jax_params(params)
        loss, _ = api["train_loss"](params, cfg, batch, policy=policy)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def compute_grads(params, batch) -> tuple[torch.Tensor, dict, dict]:
        if microbatch is None or microbatch <= 1:
            loss, grads = loss_and_grads(params, batch)
            return loss, {"loss": loss}, grads
        b = next(iter(batch.values())).shape[0]
        if b % microbatch:
            raise ValueError(f"batch of {b} does not split into {microbatch} microbatches")
        mb = b // microbatch
        loss_sum = torch.zeros((), dtype=torch.float32, device=params.embed.device)
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in named_jax_params(params).items()}
        for i in range(microbatch):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, part = loss_and_grads(params, micro)
            grads = {k: g + part[k] for k, g in grads.items()}
            loss_sum = loss_sum + loss
        loss = loss_sum / microbatch
        return loss, {"loss": loss}, {k: g / microbatch for k, g in grads.items()}

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        lr = cosine_warmup_schedule(opt_state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                                    total_steps=total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr=lr, b1=b1, b2=b2,
                                             weight_decay=weight_decay)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step
