"""Architecture registry of the port: every architecture of the reference.

``get_config(arch_id)`` returns the config of a served and trained LM
(``repro_torch.launch.serve``, ``repro_torch.launch.train``): the dense
``stablelm-1.6b``, ``gemma-7b``, ``qwen1.5-32b`` and ``deepseek-67b``, the
MoE ``granite-moe-1b-a400m`` and ``llama4-maverick-400b-a17b``, the SSM
``mamba2-130m``, the hybrid ``recurrentgemma-2b``, the encoder-decoder
``whisper-medium`` (audio-frame stub) and the VLM backbone ``qwen2-vl-2b``
(M-RoPE, vision-embedding stub); or of ``paper-vit-b32`` (the LoRA
geometry of the aggregation paths).  Unknown ids raise ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_ARCH_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gemma-7b": "gemma_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "deepseek-67b": "deepseek_67b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "whisper-medium": "whisper_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "paper-vit-b32": "paper_vit_b32",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG


__all__ = ["get_config"]
