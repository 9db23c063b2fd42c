"""Mamba-2 SSD (state-space duality) mixer: prefill through the chunked scan
kernel, decode one step at a time (port of ``repro/models/ssd.py``).

Follows Dao & Gu (2024, arXiv:2405.21060): the selective SSM

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T      (per head)
    y_t = C_t . h_t + D x_t

* Prefill and training run ``kernels.ops.ssd_scan``: the CUDA kernel on a card, its
  plain sequential scan on the CPU.  It takes the place of the reference's
  associative-scan ``ssd_chunked`` (the jnp twin of the same Pallas kernel)
  and returns the final state that decode starts from.
* Decode runs ``ssd_decode_step`` in plain torch, as the reference computes
  it outside any kernel, and writes the new state and conv window into the
  ``SSMState`` tensors in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.kvcache import SSMState


def ssd_dims(cfg) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return dict(
        d_inner=d_inner,
        n_heads=n_heads,
        head_dim=cfg.ssm_head_dim,
        state=cfg.ssm_state,
        conv_dim=d_inner + 2 * cfg.ssm_state,  # conv over [x, B, C]
    )


def lora_dims(cfg) -> dict:
    """{target: (d_in, d_out)}: the adapters sit on ``in_proj`` ("q") and
    ``out_proj`` ("v"), whatever ``cfg.lora.targets`` says (the reference's
    block LoRA)."""
    dims = ssd_dims(cfg)
    d_in_proj = dims["d_inner"] + dims["conv_dim"] + dims["n_heads"]  # z, xBC, dt
    return {"q": (cfg.d_model, d_in_proj), "v": (dims["d_inner"], cfg.d_model)}


class SSD(nn.Module):
    """The mixer's parameters, named as the reference's pytree node
    (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``,
    ``norm``, ``out_proj``) and read by key."""

    def __getitem__(self, key: str):
        return getattr(self, key)


def init_ssd(gen, cfg, *, dtype, device) -> SSD:
    """The reference's initializer on ``gen``; ``gen=None`` leaves the random
    weights unfilled (the converter writes them).  ``A_log``, ``dt_bias``
    and ``D`` are float32 in any model dtype, as in the reference."""
    dims = ssd_dims(cfg)
    d_in, d_out = lora_dims(cfg)["q"]
    h = dims["n_heads"]
    p = SSD()
    p.in_proj = layers.init_dense(gen, d_in, d_out, dtype=dtype, device=device)
    conv_w = torch.empty((cfg.conv_width, dims["conv_dim"]), dtype=dtype, device=device)
    if gen is not None:
        conv_w.normal_(0.0, 0.1, generator=gen)
    p.conv_w = layers._param(conv_w)
    p.conv_b = layers._param(torch.zeros((dims["conv_dim"],), dtype=dtype, device=device))
    f32 = dict(dtype=torch.float32, device=device)
    p.A_log = layers._param(torch.log(torch.linspace(1.0, 16.0, h, **f32)))
    p.dt_bias = layers._param(torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h, **f32))))
    p.D = layers._param(torch.ones((h,), **f32))
    p.norm = nn.ParameterDict({"scale": layers._param(
        torch.ones((dims["d_inner"],), dtype=dtype, device=device))})
    p.out_proj = layers.init_dense(gen, dims["d_inner"], cfg.d_model, dtype=dtype, device=device)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, x (B, S, C), w (K, C), then
    SiLU; the reference's unrolled adds, in its order."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) positive
    a_log: torch.Tensor,  # (H,)  A = -exp(a_log)
    b_mat: torch.Tensor,  # (B, S, N)  (single group)
    c_mat: torch.Tensor,  # (B, S, N)
    d_skip: torch.Tensor,  # (H,)
    chunk: int,
    h_init: Optional[torch.Tensor] = None,  # (B, H, P, N)
    *,
    return_state: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (y (B, S, H, P), final_state (B, H, P, N), or None without
    ``return_state``).

    Folds (B, S, H, P) into (B*H, S, P) rows, premultiplies by dt and calls
    ``ops.ssd_scan`` with B and C as one group per batch row (read by all its
    heads, not copied), then adds the D skip.  ``h_init`` is the state
    before position 0 (zero when None), on either device.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    a = -torch.exp(a_log)
    da = (dt * a[None, None, :]).permute(0, 2, 1).reshape(bsz * h, s).contiguous()
    xk = (x * dt[..., None]).permute(0, 2, 1, 3).reshape(bsz * h, s, p).contiguous()
    bk, ck = b_mat.contiguous(), c_mat.contiguous()
    h0 = (None if h_init is None
          else h_init.float().reshape(bsz * h, p, n).transpose(1, 2).contiguous())
    if return_state:
        y, final = ops.ssd_scan(xk, da, bk, ck, chunk=chunk, return_state=True, h0=h0)
    else:
        y, final = ops.ssd_scan(xk, da, bk, ck, chunk=chunk, h0=h0), None
    y = y.reshape(bsz, h, s, p).permute(0, 2, 1, 3)
    y = y + x * d_skip[None, None, :, None]
    if final is None:
        return y, None
    return y, final.reshape(bsz, h, n, p).transpose(-1, -2)


def ssd_decode_step(
    x: torch.Tensor,  # (B, 1, H, P)
    dt: torch.Tensor,  # (B, 1, H)
    a_log: torch.Tensor,
    b_mat: torch.Tensor,  # (B, 1, N)
    c_mat: torch.Tensor,  # (B, 1, N)
    d_skip: torch.Tensor,
    h: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    a = -torch.exp(a_log)
    da = torch.exp(dt[:, 0] * a[None, :])  # (B, H)
    update = torch.einsum("bhp,bn->bhpn", (x * dt[..., None])[:, 0], b_mat[:, 0])
    h_new = h * da[..., None, None] + update
    y = torch.einsum("bn,bhpn->bhp", c_mat[:, 0], h_new)[:, None]
    return y + x * d_skip[None, None, :, None], h_new


def apply_ssd(params, lora, x: torch.Tensor, cfg, *, state: Optional[SSMState] = None,
              lora_scale: float = 1.0, return_state: bool = False):
    """Full SSD mixer: in_proj -> conv -> SSD -> gated norm -> out_proj;
    returns (output, new_state).

    LoRA attaches to in_proj ("q") and out_proj ("v").  Prefill
    (``state is None``) returns, with ``return_state``, the final SSM state
    and the last K-1 pre-conv inputs.  Decode advances one token from
    ``state``, writes the new state and conv window into its tensors in
    place and returns the same object.
    """
    lora = lora or {}
    dims = ssd_dims(cfg)
    h_heads, p_dim, n_state = dims["n_heads"], dims["head_dim"], dims["state"]
    d_inner, conv_dim = dims["d_inner"], dims["conv_dim"]

    proj = layers.dense(x, params["in_proj"], lora.get("q"), lora_scale)
    z, xbc, dt_raw = torch.split(proj, [d_inner, conv_dim, h_heads], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])

    new_state = state
    if state is None:
        conv_tail = None
        if return_state:  # prefill: keep the last K-1 pre-conv inputs
            conv_tail = xbc[:, -(cfg.conv_width - 1):, :]
            short = cfg.conv_width - 1 - conv_tail.shape[1]
            if short > 0:
                conv_tail = F.pad(conv_tail, (0, 0, short, 0))
        xbc = _causal_conv(xbc, params["conv_w"].to(x.dtype), params["conv_b"])
        xs, b_mat, c_mat = torch.split(xbc, [d_inner, n_state, n_state], dim=-1)
        xs = xs.reshape(*xs.shape[:2], h_heads, p_dim)
        y, h_final = ssd_chunked(xs.float(), dt, params["A_log"], b_mat.float(), c_mat.float(),
                                 params["D"], cfg.ssm_chunk, return_state=return_state)
        if return_state:
            new_state = SSMState(h=h_final, conv=conv_tail.contiguous())
    else:
        # Decode: roll the conv window, one step of the recurrence.
        conv_in = torch.cat([state.conv, xbc], dim=1)  # (B, K, conv_dim)
        w = params["conv_w"].to(x.dtype)
        conv_out = torch.einsum("bkc,kc->bc", conv_in, w) + params["conv_b"]
        xbc1 = F.silu(conv_out)[:, None]
        xs, b_mat, c_mat = torch.split(xbc1, [d_inner, n_state, n_state], dim=-1)
        xs = xs.reshape(xs.shape[0], 1, h_heads, p_dim)
        y, h_new = ssd_decode_step(xs.float(), dt, params["A_log"], b_mat.float(),
                                   c_mat.float(), params["D"], state.h)
        state.h.copy_(h_new)
        state.conv.copy_(conv_in[:, 1:])

    y = y.reshape(*y.shape[:2], d_inner).to(x.dtype)
    # Gated RMSNorm (Mamba-2): norm(y * silu(z)).
    y = layers.apply_norm(params["norm"], y * F.silu(z))
    return layers.dense(y, params["out_proj"], lora.get("v"), lora_scale), new_state


def init_ssm_state(batch: int, cfg, dtype=torch.float32, *, device="cpu") -> SSMState:
    dims = ssd_dims(cfg)
    return SSMState(
        h=torch.zeros((batch, dims["n_heads"], dims["head_dim"], dims["state"]),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, dims["conv_dim"]), dtype=dtype,
                         device=device),
    )
