"""Feed-forward blocks: SwiGLU and GeGLU (port of ``repro/models/ffn.py``).
The plain GELU MLP (Whisper's) is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

GATED = {"swiglu": F.silu, "geglu": layers.gelu}


def _not_ported(kind):
    return NotImplementedError(
        f"ffn kind {kind!r} is not ported yet (ROADMAP.md queue 1, item 8)"
    )


def init_ffn(gen, d_model: int, d_ff: int, kind: str, *, dtype, device) -> nn.ModuleDict:
    if kind not in GATED:
        raise _not_ported(kind)
    mk = lambda d_in, d_out: layers.init_dense(gen, d_in, d_out, dtype=dtype, device=device)
    return nn.ModuleDict({"gate": mk(d_model, d_ff), "up": mk(d_model, d_ff),
                          "down": mk(d_ff, d_model)})


def apply_ffn(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """act(x W_gate) * (x W_up), then W_down; act is SiLU (SwiGLU) or the
    tanh GELU (GeGLU)."""
    if kind not in GATED:
        raise _not_ported(kind)
    h = GATED[kind](layers.dense(x, params["gate"])) * layers.dense(x, params["up"])
    return layers.dense(h, params["down"])
