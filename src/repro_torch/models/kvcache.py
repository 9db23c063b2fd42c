"""KV-cache and recurrent-state containers for decode (port of
``repro/models/kvcache.py``).

The port's decode writes each new token's K and V into the cache tensors in
place (``attention.apply_attention``), and each new SSM state into the
``SSMState`` tensors (``ssd.apply_ssd``), where the reference returns
updated copies; the positions, the mask and the recurrences are the
reference's.  The int8 cache and the RG-LRU state are not ported yet.
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


def attn_cache(batch: int, length: int, n_kv: int, head_dim: int, dtype,
               quantized: bool = False, *, device="cpu") -> KVCache:
    if quantized:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md queue 1, item 8)"
        )
    shape = (batch, length, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
