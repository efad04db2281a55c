"""LM training step (`step.make_train_step`): loss, gradients, AdamW."""

from repro_torch.train.step import make_train_step  # noqa: F401
