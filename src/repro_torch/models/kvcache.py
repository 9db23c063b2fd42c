"""KV-cache and recurrent-state containers for decode (port of
``repro/models/kvcache.py``).

The port's decode writes each new token's K and V into the cache tensors in
place (``attention.apply_attention``; slot ``t % ring`` of a sliding-window
ring), and each new recurrent state into the ``SSMState`` / ``LRUState``
tensors (``ssd.apply_ssd``, ``rglru.apply_rglru``), where the reference
returns updated copies; the positions, the mask and the recurrences are the
reference's.  The int8 cache is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, S_cache, n_kv, head_dim)
    v: torch.Tensor


class SSMState(NamedTuple):
    h: torch.Tensor  # (..., B, n_heads, head_dim, state) float32
    conv: torch.Tensor  # (..., B, conv_width - 1, conv_dim)


class LRUState(NamedTuple):
    h: torch.Tensor  # (..., B, lru_width) float32
    conv: torch.Tensor  # (..., B, conv_width - 1, lru_width)


def attn_cache(batch: int, length: int, n_kv: int, head_dim: int, dtype,
               quantized: bool = False, *, device="cpu") -> KVCache:
    if quantized:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md queue 1, item 8)"
        )
    shape = (batch, length, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
