"""Architecture registry of the port: every architecture of the reference,
the assigned shapes and meta-tensor input specs for the dry run.

``get_config(arch_id)`` returns the config of a served and trained LM
(``repro_torch.launch.serve``, ``repro_torch.launch.train``): the dense
``stablelm-1.6b``, ``gemma-7b``, ``qwen1.5-32b`` and ``deepseek-67b``, the
MoE ``granite-moe-1b-a400m`` and ``llama4-maverick-400b-a17b``, the SSM
``mamba2-130m``, the hybrid ``recurrentgemma-2b``, the encoder-decoder
``whisper-medium`` (audio-frame stub) and the VLM backbone ``qwen2-vl-2b``
(M-RoPE, vision-embedding stub); or of ``paper-vit-b32`` (the LoRA
geometry of the aggregation paths).  Unknown ids raise ``KeyError``.

``input_specs`` builds allocation-free stand-ins (tensors on the ``meta``
device, PyTorch's counterpart of ``jax.ShapeDtypeStruct``) for every model
input of a (config, shape); ``launch/dryrun.py`` reckons with them.

long_500k policy (the reference's): sub-quadratic archs (ssm / hybrid) run
natively; quadratic archs run their sliding-window variant (window 4096)
selected by ``config_for_shape``; whisper-medium skips the shape entirely.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K

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


#: The dry run's architectures, in the reference's order.
ARCH_IDS = ("recurrentgemma-2b", "llama4-maverick-400b-a17b", "qwen2-vl-2b", "qwen1.5-32b",
            "stablelm-1.6b", "deepseek-67b", "whisper-medium", "mamba2-130m",
            "granite-moe-1b-a400m", "gemma-7b")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is part of the dry-run matrix."""
    if shape.name == "long_500k":
        # Whisper's decoder has a hard bounded context: skipped.
        return not cfg.encoder_decoder
    return True


def config_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Arch variant actually run for a shape.

    long_500k on quadratic archs switches full attention to the
    sliding-window variant (window 4096) so the decode state is bounded.
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        pattern = tuple("local_attn" if k == "attn" else k for k in cfg.layer_pattern)
        return cfg.replace(layer_pattern=pattern, window_size=4096)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                n_clients: Optional[int] = None) -> dict:
    """Meta-tensor stand-ins for every input of the step being run.

    train: federated layout, tokens / labels (n_clients, per_client_batch, S).
    prefill: request batch (B, S) (+ frontend stubs).
    decode: one token (B, 1); the caches come from
    ``models.init_decode_caches`` (on ``meta`` too).

    A VLM's prefill and train inputs carry the stub patch embeddings
    ``vision_embeds`` (..., n_vision_tokens, d_model) and an audio config's
    the stub frames ``encoder_frames`` (..., encoder_seq, d_model), in the
    model's dtype; tokens and labels are int32.
    """
    meta = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    i32 = torch.int32
    s, b = shape.seq_len, shape.global_batch
    specs: dict = {}
    if shape.kind == "train":
        m = n_clients or 1
        per = max(b // m, 1)
        specs["tokens"] = meta((m, per, s), i32)
        specs["labels"] = meta((m, per, s), i32)
        lead = (m, per)
    elif shape.kind == "prefill":
        specs["tokens"] = meta((b, s), i32)
        lead = (b,)
    else:  # decode
        specs["tokens"] = meta((b, 1), i32)
        lead = (b,)

    dtype = _DTYPES[cfg.dtype]
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["vision_embeds"] = meta((*lead, cfg.n_vision_tokens, cfg.d_model), dtype)
    if cfg.frontend == "audio" and shape.kind != "decode":
        specs["encoder_frames"] = meta((*lead, cfg.encoder_seq, cfg.d_model), dtype)
    return specs


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "all_configs",
    "config_for_shape",
    "get_config",
    "input_specs",
    "shape_supported",
]
