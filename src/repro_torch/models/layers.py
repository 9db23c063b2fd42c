"""Shared primitive layers: norms, rotary embeddings, dense + LoRA projection
(port of ``repro/models/layers.py``).

Parameters live in ``nn.ParameterDict``s shaped as the reference's pytree
nodes (``{"w": (d_in, d_out), "b": (d_out,)}``, ``{"scale", "bias"}``), so
the converter and the tests address both packages by the same keys.
Initializers draw from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_norm(kind: str, dim: int, device) -> nn.ParameterDict:
    """Norm parameters, always float32 as in the reference."""
    ones = torch.ones((dim,), dtype=torch.float32, device=device)
    if kind == "rmsnorm":
        return nn.ParameterDict({"scale": _param(ones)})
    if kind == "layernorm":
        return nn.ParameterDict({"scale": _param(ones), "bias": _param(torch.zeros_like(ones))})
    raise ValueError(kind)


def apply_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (population variance) or RMSNorm, computed in float32 and
    cast back to x's dtype."""
    xf = x.float()
    if "bias" in params:  # layernorm
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return out.to(x.dtype)


def init_dense(gen, d_in: int, d_out: int, *, bias: bool = False, dtype, device):
    """W ~ U(-1/sqrt(d_in), 1/sqrt(d_in)) drawn on ``device``; ``gen=None``
    leaves W unfilled (the converter writes it)."""
    w = torch.empty((d_in, d_out), dtype=dtype, device=device)
    if gen is not None:
        scale = 1.0 / math.sqrt(d_in)
        w.uniform_(-scale, scale, generator=gen)
    p = {"w": _param(w)}
    if bias:
        p["b"] = _param(torch.zeros((d_out,), dtype=dtype, device=device))
    return nn.ParameterDict(p)


def init_lora(gen, d_in: int, d_out: int, rank: int, *, dtype, device, lead=()):
    """LoRA pair, delta_W = A @ B with A (d_in, r) ~ N(0, 1/d_in) and
    B (r, d_out) zero, so a fresh adapter is a no-op; ``lead`` prepends
    axes (the layer-group axis)."""
    a = torch.empty((*lead, d_in, rank), dtype=dtype, device=device)
    a.normal_(0.0, 1.0 / math.sqrt(d_in), generator=gen)
    return {"A": a, "B": torch.zeros((*lead, rank, d_out), dtype=dtype, device=device)}


def dense(x: torch.Tensor, params, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
    """y = x @ W (+ s * (x @ A) @ B) (+ b).

    The adapter, when there is one, goes through a fused kernel with W:

    * ``{"A": (d_in, r), "B": (r, d_out)}`` — one adapter for every row:
      ``ops.lora_matmul``;
    * ``{"A": (n, d_in, r), "B": (n, r, d_out), "slots": (B,)}`` — a pool
      slice and each request's slot (``serve.pool.adapter_view``):
      ``ops.gathered_lora_matmul`` reads the pool in place;
    * ``{"A": (B, d_in, r), "B": (B, r, d_out)}`` — one adapter per request
      (the reference's batched branch): the same gathered kernel, request b
      naming slot b.

    A projection with no adapter is a plain ``torch.matmul``.  The kernels
    round once after adding the correction to the fp32 base product, where
    the reference rounds x @ W first; in float32 the two agree to rounding.
    """
    w = params["w"].to(x.dtype)
    if lora is None:
        y = torch.matmul(x, w)
    elif "slots" in lora:
        y = ops.gathered_lora_matmul(x, w, lora["A"], lora["B"], lora["slots"], lora_scale)
    elif lora["A"].ndim == 3:
        slots = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
        y = ops.gathered_lora_matmul(x, w, lora["A"], lora["B"], slots, lora_scale)
    else:
        y = ops.lora_matmul(x, w, lora["A"], lora["B"], lora_scale)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def rope_frequencies(head_dim: int, theta: float, rope_pct: float = 1.0,
                     device=None) -> torch.Tensor:
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta**exponent)  # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integers.  Rotates the first
    ``rope_pct`` fraction of the head dim (StableLM's partial rotary)."""
    dh = x.shape[-1]
    inv_freq = rope_frequencies(dh, theta, rope_pct, device=x.device)
    rot = inv_freq.shape[0] * 2
    angles = positions[..., None].float() * inv_freq[None, None, :]  # (B, S, R/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, Dh); positions_3d: (3, B, S),
    the temporal, height and width position streams.  ``sections`` counts
    the frequency pairs each stream drives, in order (sum(sections) ==
    Dh // 2); the rotation is ``apply_rope``'s, over the full head width in
    non-interleaved halves.  Equal streams (text tokens) reduce it to
    ``apply_rope`` at ``rope_pct = 1``."""
    dh = x.shape[-1]
    assert sum(sections) == dh // 2, (sections, dh)
    inv_freq = rope_frequencies(dh, theta, device=x.device)  # (Dh/2,)
    section_ids = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.as_tensor(sections, device=x.device))  # (Dh/2,) in {0, 1, 2}
    pos = positions_3d.float()[section_ids].permute(1, 2, 0)  # (B, S, Dh/2)
    angles = pos * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping; identity when cap == 0."""
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x
