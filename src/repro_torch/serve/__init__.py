"""Multi-tenant LoRA serving: the paged adapter pool (port of
``repro/serve``)."""
from repro_torch.serve.pool import AdapterPool, adapter_view, merged_view

__all__ = ["AdapterPool", "adapter_view", "merged_view"]
