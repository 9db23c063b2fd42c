"""Attention: causal self-attention with RoPE, full or sliding-window,
prefill and decode (port of ``repro/models/attention.py``).

* Prefill runs ``kernels.ops.local_attention``: the CUDA flash kernel on a
  card, its plain version on the CPU.  It takes the place of the
  reference's switch between ``naive_attention`` and ``flash_attention``
  (the jnp twin of the same Pallas kernel).  Grouped queries (MQA at
  kv = 1) repeat K and V per group there (``ops.local_attention``).
* Decode runs ``decode_attention``, one query against the cache, in plain
  torch, as the reference computes it outside any kernel.  A
  sliding-window mixer's cache is a ring: token t sits at slot t % ring.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.kvcache import KVCache

NEG_INF = -1e30


def init_attention(gen, cfg, *, dtype, device) -> nn.ModuleDict:
    d = cfg.d_model
    mk = lambda d_in, d_out, bias: layers.init_dense(gen, d_in, d_out, bias=bias, dtype=dtype,
                                                     device=device)
    return nn.ModuleDict({
        "q": mk(d, cfg.q_dim, cfg.qkv_bias),
        "k": mk(d, cfg.kv_dim, cfg.qkv_bias),
        "v": mk(d, cfg.kv_dim, cfg.qkv_bias),
        "o": mk(cfg.q_dim, d, False),
    })


def lora_dims(cfg) -> dict:
    """{target: (d_in, d_out)} of every projection an adapter may target."""
    return {"q": (cfg.d_model, cfg.q_dim), "k": (cfg.d_model, cfg.kv_dim),
            "v": (cfg.d_model, cfg.kv_dim), "o": (cfg.q_dim, cfg.d_model)}


def naive_attention(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0,
                    kv_len=None) -> torch.Tensor:
    """Materialized-score attention; q (B, Sq, n_kv, G, D), k and v
    (B, Sk, n_kv, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bshd->bhgqs", q, k).float() * scale
    sq, sk = q.shape[1], k.shape[1]
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqs,bshd->bqhgd", p, v)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """Single-token attention against a cache: q (B, 1, n_kv, G, D), caches
    (B, S_cache, n_kv, D), ``cache_len`` the valid length after the insert
    (an int, compared on the device with no copy, or a per-batch (B,)
    tensor)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bshd->bhgqs", q, k_cache).float() * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    clen = cache_len if isinstance(cache_len, int) else cache_len.reshape(-1, 1)
    valid = pos[None, :] < clen
    if window and not ring:
        valid = valid & (pos[None, :] > clen - window)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqs,bshd->bqhgd", p, v_cache)


def ring_cache(k: torch.Tensor, v: torch.Tensor, window: int) -> KVCache:
    """The decode cache of a sliding-window prefill of S positions, k and v
    (B, S, n_kv, hd): with S >= window, the last ``window`` keys rolled by
    S % window, so that position p sits at slot p % window where decode
    writes it; a shorter prompt keeps its S keys at slots 0..S-1."""
    s = k.shape[1]
    if s < window:
        return KVCache(k=k, v=v)
    return KVCache(k=torch.roll(k[:, -window:], shifts=s % window, dims=1),
                   v=torch.roll(v[:, -window:], shifts=s % window, dims=1))


def apply_attention(params, lora, x: torch.Tensor, cfg, *, positions, window: int = 0,
                    cache: Optional[KVCache] = None, cache_index: Optional[int] = None,
                    return_cache: bool = False):
    """Causal self-attention, full (``window=0``, the ``"attn"`` mixer) or
    over the last ``window`` positions (``"local_attn"``); returns (output,
    new_cache).

    Prefill (``cache is None``) attends over x and, with ``return_cache``,
    returns its K and V as the decode cache (``ring_cache`` with a window).
    Decode writes the new K and V in place, at position ``cache_index`` of
    ``cache`` or, with a window, at slot ``cache_index % ring`` of the ring,
    and attends to every slot written so far (a ring's recency does not
    matter to the softmax, as in the reference); the returned cache is the
    same object.  Cross-attention, M-RoPE and the int8 cache are not ported
    yet (``blocks.check_ported`` refuses configs that need them).
    """
    lora = lora or {}
    scale = cfg.lora.scale
    n_kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    b, sq = x.shape[0], x.shape[1]
    q = layers.dense(x, params["q"], lora.get("q"), scale).reshape(b, sq, n_kv * g, hd)
    k = layers.dense(x, params["k"], lora.get("k"), scale).reshape(b, sq, n_kv, hd)
    v = layers.dense(x, params["v"], lora.get("v"), scale).reshape(b, sq, n_kv, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)

    new_cache = cache
    if cache is not None:
        ring = cache.k.shape[1] if window else 0
        slot = cache_index % ring if ring else cache_index
        cache.k[:, slot:slot + sq] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + sq] = v.to(cache.v.dtype)
        total = cache_index + sq
        out = decode_attention(q.reshape(b, sq, n_kv, g, hd), cache.k.to(q.dtype),
                               cache.v.to(q.dtype), min(total, ring) if ring else total,
                               window=window, ring=bool(ring))
    else:
        out = ops.local_attention(q, k, v, window=window, causal=True)
        if return_cache:
            new_cache = ring_cache(k, v, window) if window else KVCache(k=k, v=v)
    out = out.reshape(b, sq, n_kv * g * hd)
    return layers.dense(out, params["o"], lora.get("o"), scale), new_cache
