"""Feed-forward blocks: SwiGLU, GeGLU and the plain GELU MLP (port of
``repro/models/ffn.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

GATED = {"swiglu": F.silu, "geglu": layers.gelu}


def init_ffn(gen, d_model: int, d_ff: int, kind: str, *, dtype, device) -> nn.ModuleDict:
    mk = lambda d_in, d_out, bias=False: layers.init_dense(gen, d_in, d_out, bias=bias,
                                                           dtype=dtype, device=device)
    if kind in GATED:
        return nn.ModuleDict({"gate": mk(d_model, d_ff), "up": mk(d_model, d_ff),
                              "down": mk(d_ff, d_model)})
    if kind == "gelu":
        return nn.ModuleDict({"up": mk(d_model, d_ff, True), "down": mk(d_ff, d_model, True)})
    raise ValueError(kind)


def apply_ffn(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Gated: act(x W_gate) * (x W_up), then W_down; act is SiLU (SwiGLU) or
    the tanh GELU (GeGLU).  ``gelu`` (Whisper's MLP): the tanh GELU of
    x W_up + b_up, then W_down + b_down."""
    if kind in GATED:
        h = GATED[kind](layers.dense(x, params["gate"])) * layers.dense(x, params["up"])
        return layers.dense(h, params["down"])
    if kind == "gelu":
        return layers.dense(layers.gelu(layers.dense(x, params["up"])), params["down"])
    raise ValueError(kind)
