"""Feed-forward block: SwiGLU (port of ``repro/models/ffn.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


def _not_ported(kind):
    return NotImplementedError(
        f"ffn kind {kind!r} is not ported yet (ROADMAP.md queue 1, item 8)"
    )


def init_ffn(gen, d_model: int, d_ff: int, kind: str, *, dtype, device) -> nn.ModuleDict:
    if kind != "swiglu":
        raise _not_ported(kind)
    mk = lambda d_in, d_out: layers.init_dense(gen, d_in, d_out, dtype=dtype, device=device)
    return nn.ModuleDict({"gate": mk(d_model, d_ff), "up": mk(d_model, d_ff),
                          "down": mk(d_ff, d_model)})


def apply_ffn(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise _not_ported(kind)
    h = F.silu(layers.dense(x, params["gate"])) * layers.dense(x, params["up"])
    return layers.dense(h, params["down"])
