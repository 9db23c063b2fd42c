"""Optimizers over LoRA trees (SGD / Adam / AdamW) and learning-rate schedules."""
from repro_torch.optim.optimizers import Optimizer, adam, adamw, apply_updates, make_optimizer, sgd
from repro_torch.optim.schedules import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "make_optimizer", "sgd",
           "constant_schedule", "cosine_schedule", "linear_warmup_cosine"]
