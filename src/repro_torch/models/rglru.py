"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; port
of ``repro/models/rglru.py``).

Recurrence (per channel):

    r_t = sigmoid(W_a y_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x y_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

The surrounding block is Griffin's: dual input projections (main + GELU
gate), a width-4 causal depthwise conv on the main branch, the RG-LRU,
gating, and an output projection.  LoRA attaches to ``proj_x`` ("q") and
``out_proj`` ("v").

* Prefill and training evaluate the linear recurrence with ``rglru_scan``,
  log-depth doubling passes in plain PyTorch: the reference evaluates it
  with ``lax.associative_scan``, an XLA primitive and not a Pallas kernel.
  Training differentiates it through ``_Scan``, whose backward is the
  reverse scan in the same passes (while tracing, the span
  ``repro.rglru.backward``).
* Decode advances one token and writes the new state and conv window into
  the ``LRUState`` tensors in place, as the SSD mixer writes its state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import backend
from repro_torch.models import layers
from repro_torch.models.kvcache import LRUState
from repro_torch.utils import trace

_C = 8.0


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def lora_dims(cfg) -> dict:
    """{target: (d_in, d_out)}: the adapters sit on ``proj_x`` ("q") and
    ``out_proj`` ("v"), whatever ``cfg.lora.targets`` says (the reference's
    block LoRA)."""
    w = lru_width(cfg)
    return {"q": (cfg.d_model, w), "v": (w, cfg.d_model)}


class RGLRU(nn.Module):
    """The mixer's parameters, named as the reference's pytree node
    (``proj_x``, ``proj_gate``, ``conv_w``, ``conv_b``, ``gate_a``,
    ``gate_x``, ``lambda``, ``out_proj``) and read by key: ``lambda`` is a
    Python keyword, so it is registered by name and never read as an
    attribute."""

    def __getitem__(self, key: str):
        return getattr(self, key)


def init_rglru(gen, cfg, *, dtype, device) -> RGLRU:
    """The reference's initializer on ``gen``; ``gen=None`` leaves the random
    weights unfilled (the converter writes them).  ``lambda`` is float32 in
    any model dtype, spread so that a = exp(-c softplus(lambda)) spans about
    (0.9, 0.999), as in the reference."""
    w, d = lru_width(cfg), cfg.d_model
    dense = lambda d_in, d_out, bias=False: layers.init_dense(gen, d_in, d_out, bias=bias,
                                                              dtype=dtype, device=device)
    p = RGLRU()
    p.proj_x = dense(d, w)
    p.proj_gate = dense(d, w)
    conv_w = torch.empty((cfg.conv_width, w), dtype=dtype, device=device)
    if gen is not None:
        conv_w.normal_(0.0, 0.1, generator=gen)
    p.conv_w = layers._param(conv_w)
    p.conv_b = layers._param(torch.zeros((w,), dtype=dtype, device=device))
    p.gate_a = dense(w, w, True)
    p.gate_x = dense(w, w, True)
    p.register_parameter("lambda", layers._param(
        torch.linspace(-4.0, -1.0, w, dtype=torch.float32, device=device)))
    p.out_proj = dense(w, d)
    return p


def _gates(params, y: torch.Tensor):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32, from the
    conv output y (B, S, W); beta = sqrt(1 - a^2) floored at 1e-12 inside
    the root, as the reference floors it."""
    r = torch.sigmoid(layers.dense(y, params["gate_a"]).float())
    i = torch.sigmoid(layers.dense(y, params["gate_x"]).float())
    log_a = -_C * F.softplus(params["lambda"])[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (i * y.float())


def _doubling(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over the leading axis of sequence-major
    (S, ...) inputs, from a zero state, in ceil(log2 S) doubling passes:
    pass k combines each position with the one 2^k before it, (a, b) o
    (a', b') = (a a', b a' + b'), the reference's associative combine.  Each
    shifted operand is one contiguous block, and each pass writes fresh
    buffers with ``out=`` (no concatenation).  Returns h, sequence-major."""
    s = a.shape[0]
    shift = 1
    while shift < s:
        na, nb = torch.empty_like(a), torch.empty_like(b)
        nb[:shift] = b[:shift]
        torch.addcmul(b[shift:], a[shift:], b[:-shift], out=nb[shift:])
        na[:shift] = a[:shift]
        torch.mul(a[shift:], a[:-shift], out=na[shift:])
        a, b = na, nb
        shift *= 2
    return b


class _Scan(torch.autograd.Function):
    """The doubling scan with the reverse scan as its backward:
    g_t = dL/dh_t + a_{t+1} g_{t+1} (a_S = 0 past the end), dL/db_t = g_t,
    dL/da_t = g_t h_{t-1} (h_{-1} = 0).  The reverse scan runs as doubling
    passes too, on the flipped sequence; every step is elementwise, so the
    gradients are deterministic.  It keeps two sequence-major tensors, a and
    h, where out-of-place passes would keep two a pass."""

    @staticmethod
    def forward(ctx, a_sm, b_sm):
        h = _doubling(a_sm, b_sm)
        ctx.save_for_backward(a_sm, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        with trace.span("repro.rglru.backward"):
            a_next = torch.zeros_like(a)
            a_next[:-1] = a[1:]
            g = _doubling(a_next.flip(0), gh.flip(0)).flip(0)
            da = torch.zeros_like(a)
            torch.mul(g[1:], h[:-1], out=da[1:])
        return da, g


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over the sequence axis of (B, S, W) inputs,
    from a zero state, by ``_doubling``'s passes.  The sums come in another
    order than a sequential loop's or ``lax.associative_scan``'s, so they
    agree to rounding.

    The passes run sequence-major, (S, B, W); the (B, S, W) result is a
    transposed view.  When autograd records the call
    (``backend.needs_grad``) the same passes run inside ``_Scan``, whose
    backward is the reverse scan; the forward's bits are the no-grad
    path's."""
    a_sm = a.transpose(0, 1).contiguous()
    b_sm = b.transpose(0, 1).contiguous()
    if backend.needs_grad(a, b):
        return _Scan.apply(a_sm, b_sm).transpose(0, 1)
    return _doubling(a_sm, b_sm).transpose(0, 1)


def _causal_conv(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, y (B, S, W), w (K, W): the
    reference's unrolled adds, in its order."""
    k = w.shape[0]
    yp = F.pad(y, (0, 0, k - 1, 0))
    out = torch.zeros_like(y)
    for i in range(k):
        out = out + yp[:, i:i + y.shape[1], :] * w[i][None, None, :]
    return out + bias[None, None, :]


def apply_rglru(params, lora, x: torch.Tensor, cfg, *, state: Optional[LRUState] = None,
                lora_scale: float = 1.0,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[LRUState]]:
    """The Griffin recurrent block on x (B, S, D); returns (output,
    new_state).

    Prefill (``state is None``) returns, with ``return_state``, the last
    position's h (float32) and the last K-1 inputs of the conv, zero-padded
    in front when the prompt is shorter, as the reference pads them.  Decode
    (one token) advances from ``state``, writes the new h and conv window
    into its tensors in place and returns the same object."""
    lora = lora or {}
    y = layers.dense(x, params["proj_x"], lora.get("q"), lora_scale)
    gate = layers.gelu(layers.dense(x, params["proj_gate"]))
    k = params["conv_w"].shape[0]

    new_state = state
    if state is None:
        conv_tail = None
        if return_state:
            conv_tail = y[:, -(k - 1):, :]
            short = k - 1 - conv_tail.shape[1]
            if short > 0:
                conv_tail = F.pad(conv_tail, (0, 0, short, 0))
        y = _causal_conv(y, params["conv_w"], params["conv_b"])
        a, b = _gates(params, y)
        h_all = rglru_scan(a, b)
        h = h_all.to(x.dtype)
        if return_state:
            # Copies, not views: h_all[:, -1] is one contiguous slab of the
            # scan's sequence-major buffer and would keep all of it alive.
            new_state = LRUState(h=h_all[:, -1].clone(), conv=conv_tail.clone())
    else:
        conv_in = torch.cat([state.conv, y], dim=1)  # (B, K, W)
        y1 = torch.einsum("bkw,kw->bw", conv_in, params["conv_w"]) + params["conv_b"]
        a, b = _gates(params, y1[:, None, :])
        h1 = a[:, 0] * state.h + b[:, 0]
        h = h1[:, None].to(x.dtype)
        state.h.copy_(h1)
        state.conv.copy_(conv_in[:, 1:])

    out = layers.dense(h * gate, params["out_proj"], lora.get("v"), lora_scale)
    return out, new_state


def init_lru_state(batch: int, cfg, dtype=torch.float32, *, device="cpu") -> LRUState:
    w = lru_width(cfg)
    return LRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    )
