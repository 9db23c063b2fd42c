"""Tree helpers over dicts of tensors (the port's LoRA trees) and the logger."""
from repro_torch.utils.logging import get_logger

__all__ = ["get_logger"]
