"""KV-cache and recurrent-state containers for decode, and the int8 KV cache
(port of ``repro/models/kvcache.py``).

The port's decode writes each new token's K and V into the cache tensors in
place (``attention.apply_attention``; slot ``t % ring`` of a sliding-window
ring), and each new recurrent state into the ``SSMState`` / ``LRUState``
tensors (``ssd.apply_ssd``, ``rglru.apply_rglru``), where the reference
returns updated copies; the positions, the mask and the recurrences are the
reference's.

A quantized cache (``cfg.kv_quant``) stores int8 values with one float16
scale per (token, kv head): 0.516x the bytes of a bf16 cache at head width
64, 0.508x at 128.  ``quantize_kv`` and ``dequantize_kv`` compute the
reference's bits: the scale is rounded to float16 before the division, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, S_cache, n_kv, head_dim)
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    k_q: torch.Tensor  # int8 (..., B, S_cache, n_kv, head_dim)
    v_q: torch.Tensor
    k_scale: torch.Tensor  # float16 (..., B, S_cache, n_kv, 1)
    v_scale: torch.Tensor


class SSMState(NamedTuple):
    h: torch.Tensor  # (..., B, n_heads, head_dim, state) float32
    conv: torch.Tensor  # (..., B, conv_width - 1, conv_dim)


class LRUState(NamedTuple):
    h: torch.Tensor  # (..., B, lru_width) float32
    conv: torch.Tensor  # (..., B, conv_width - 1, lru_width)


AnyKVCache = Union[KVCache, QuantKVCache]


def attn_cache(batch: int, length: int, n_kv: int, head_dim: int, dtype,
               quantized: bool = False, *, device="cpu") -> AnyKVCache:
    shape = (batch, length, n_kv, head_dim)
    if quantized:
        sshape = (batch, length, n_kv, 1)
        return QuantKVCache(
            k_q=torch.zeros(shape, dtype=torch.int8, device=device),
            v_q=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float16, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float16, device=device),
        )
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 per (token, head), over the last axis: returns (q int8,
    scale float16 with a last axis of 1)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).to(torch.float16)
    q = torch.round(xf / torch.clamp_min(scale.float(), 1e-8)).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
