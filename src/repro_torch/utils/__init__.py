"""Tree helpers over dicts of tensors (the port's LoRA trees)."""
