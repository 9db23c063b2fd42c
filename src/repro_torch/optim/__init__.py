"""Optimizers over LoRA trees (SGD / Adam / AdamW)."""
from repro_torch.optim.optimizers import Optimizer, adam, adamw, apply_updates, make_optimizer, sgd

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "make_optimizer", "sgd"]
