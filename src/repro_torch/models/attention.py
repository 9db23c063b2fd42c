"""Attention: self-attention with RoPE or M-RoPE, full or sliding-window,
bidirectional (the encoder), cross-attention over an encoder's output,
prefill and decode, with a bf16 or int8 KV cache (port of
``repro/models/attention.py``).

* Self-attention prefill runs ``kernels.ops.local_attention``: the CUDA
  flash kernel on a card, its plain version on the CPU, causal or not
  (Whisper's encoder).  It takes the place of the reference's switch
  between ``naive_attention`` and ``flash_attention`` (the jnp twin of the
  same Pallas kernel).  Grouped queries (MQA at kv = 1) repeat K and V per
  group there (``ops.local_attention``).
* Cross-attention (queries of the decoder, keys and values of the
  encoder's output; no RoPE, no mask) runs ``naive_attention`` in plain
  torch, as the reference runs it below 2048 keys: the kernel's (BH, S, D)
  contract takes no key length of its own.  At decode its K and V come from
  the cross cache, projected once at prefill.
* Decode runs ``decode_attention``, one query against the cache, in plain
  torch, as the reference computes it outside any kernel.  A
  sliding-window mixer's cache is a ring: token t sits at slot t % ring.
  An int8 cache (``QuantKVCache``) takes the new K and V quantized and is
  dequantized whole for the step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.kvcache import KVCache, QuantKVCache, dequantize_kv, quantize_kv

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
                    cache=None, cache_index: Optional[int] = None,
                    encoder_out: Optional[torch.Tensor] = None, use_rope: bool = True,
                    causal: bool = True, return_cache: bool = False, is_cross: bool = False):
    """Self-attention, full (``window=0``, the ``"attn"`` mixer) or over the
    last ``window`` positions (``"local_attn"``), causal or not; or, with
    ``is_cross``, cross-attention of x's queries over ``encoder_out``.
    Returns (output, new_cache).

    ``positions`` are (B, S) integers for RoPE, or (3, B, S) for M-RoPE
    (``cfg.mrope``); ``use_rope=False`` (Whisper) rotates nothing.

    Prefill (``cache is None``) attends over x and, with ``return_cache``,
    returns its K and V as the decode cache (``ring_cache`` with a window;
    quantized with ``cfg.kv_quant``).  Cross-attention with
    ``return_cache`` returns the encoder's K and V as the cross cache: they
    are projected once, where the reference projects them a second time for
    the cache (``blocks._encoder_kv``) with the same numbers.  Decode writes
    the new K and V in place, at position ``cache_index`` of ``cache`` or,
    with a window, at slot ``cache_index % ring`` of the ring (an int8
    cache takes them quantized), and attends to every slot written so far
    (a ring's recency does not matter to the softmax, as in the reference);
    the returned cache is the same object.  A cross cache is read only.
    """
    lora = lora or {}
    scale = cfg.lora.scale
    n_kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    b, sq = x.shape[0], x.shape[1]
    q = layers.dense(x, params["q"], lora.get("q"), scale).reshape(b, sq, n_kv * g, hd)

    def merged_out(out):
        return layers.dense(out.reshape(b, sq, n_kv * g * hd), params["o"], lora.get("o"),
                            scale)

    if is_cross and cache is not None:
        # Cached cross-attention: the encoder's K and V were projected at prefill.
        out = naive_attention(q.reshape(b, sq, n_kv, g, hd), cache.k.to(q.dtype),
                              cache.v.to(q.dtype), causal=False)
        return merged_out(out), cache

    src = encoder_out if is_cross else x
    k = layers.dense(src, params["k"], lora.get("k"), scale).reshape(b, -1, n_kv, hd)
    v = layers.dense(src, params["v"], lora.get("v"), scale).reshape(b, -1, n_kv, hd)
    if use_rope and not is_cross:
        if cfg.mrope:
            q = layers.apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = layers.apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
            k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)

    new_cache = cache
    if is_cross:
        out = naive_attention(q.reshape(b, sq, n_kv, g, hd), k, v, causal=False)
        if return_cache:
            new_cache = KVCache(k=k, v=v)
    elif cache is not None:
        quant = isinstance(cache, QuantKVCache)
        ring = cache[0].shape[1] if window else 0
        slot = cache_index % ring if ring else cache_index
        if quant:
            (k_q, k_s), (v_q, v_s) = quantize_kv(k), quantize_kv(v)
            for buf, val in zip(cache, (k_q, v_q, k_s, v_s)):
                buf[:, slot:slot + sq] = val
            k_all = dequantize_kv(cache.k_q, cache.k_scale, q.dtype)
            v_all = dequantize_kv(cache.v_q, cache.v_scale, q.dtype)
        else:
            cache.k[:, slot:slot + sq] = k.to(cache.k.dtype)
            cache.v[:, slot:slot + sq] = v.to(cache.v.dtype)
            k_all, v_all = cache.k.to(q.dtype), cache.v.to(q.dtype)
        total = cache_index + sq
        out = decode_attention(q.reshape(b, sq, n_kv, g, hd), k_all, v_all,
                               min(total, ring) if ring else total, window=window,
                               ring=bool(ring))
    else:
        out = ops.local_attention(q, k, v, window=window, causal=causal)
        if return_cache:
            new_cache = ring_cache(k, v, window) if window else KVCache(k=k, v=v)
            if cfg.kv_quant:
                (k_q, k_s), (v_q, v_s) = quantize_kv(new_cache.k), quantize_kv(new_cache.v)
                new_cache = QuantKVCache(k_q=k_q, v_q=v_q, k_scale=k_s, v_scale=v_s)
    return merged_out(out), new_cache
