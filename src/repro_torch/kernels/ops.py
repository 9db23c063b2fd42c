"""Leading-rank wrappers binding the kernels into the models (port of
``repro/kernels/ops.py``).  The tensor's device picks the kernel or its
plain version, as in every wrapper of ``repro_torch.kernels``."""
from __future__ import annotations

import torch

from repro_torch.kernels import local_attention as _la
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import soft_threshold as _st
from repro_torch.kernels import ssd_scan as _ss


def soft_threshold(x, t) -> torch.Tensor:
    """Kernel-backed shrinkage sign(x) * max(|x| - t, 0) for x of any rank,
    reshaped to 2-D as the reference reshapes it: (-1, last axis), or one
    row for rank 0 and 1."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]) if x.ndim >= 2 else x.reshape(1, -1)
    return _st.soft_threshold(x2.contiguous(), t).reshape(shape)


def lora_matmul(x, w, a, b, scale: float = 1.0) -> torch.Tensor:
    """Fused y = xW + s(xA)B for x of any leading rank."""
    lead = x.shape[:-1]
    out = _lm.lora_matmul(x.reshape(-1, x.shape[-1]), w, a, b, scale)
    return out.reshape(*lead, w.shape[-1])


def gathered_lora_matmul(x, w, a_pool, b_pool, row_slot, scale: float = 1.0) -> torch.Tensor:
    """Pooled multi-adapter y = xW + s(xA_slot)B_slot for any leading rank.

    ``row_slot`` is either per row (the leading shape of ``x``) or per
    request, ``(B,)`` for ``x: (B, S, K)``, broadcast over the sequence.
    Slot -1 means no adapter.  The reference bounds its segment layout by
    the request count (``max_segments = B``); the kernel here reads each
    row's slot itself and has no layout to bound.
    """
    lead = x.shape[:-1]
    rs = torch.as_tensor(row_slot, device=x.device).to(torch.int32)
    if tuple(rs.shape) != tuple(lead):
        if rs.ndim != 1 or len(lead) < 2 or rs.shape[0] != lead[0]:
            raise ValueError(f"row_slot shape {tuple(rs.shape)} matches neither rows "
                             f"{tuple(lead)} nor requests ({lead[0]},)")
        rs = rs.reshape(rs.shape + (1,) * (len(lead) - 1)).expand(lead)
    out = _lm.gathered_lora_matmul(x.reshape(-1, x.shape[-1]), w, a_pool, b_pool,
                                   rs.reshape(-1).contiguous(), scale)
    return out.reshape(*lead, w.shape[-1])


def local_attention(q, k, v, *, window: int = 0, causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention, folded to (B*H, S, D) for the kernel; K and V
    with fewer heads than Q (grouped queries) are repeated per group.
    Three-dimensional inputs go to the kernel as they are."""
    if q.ndim == 3:
        return _la.local_attention(q, k, v, window=window, causal=causal)
    bsz, s, h, d = q.shape
    group = h // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(bsz * h, s, d)
    out = _la.local_attention(fold(q), fold(k), fold(v), window=window, causal=causal)
    return out.reshape(bsz, h, s, d).transpose(1, 2)


def ssd_scan(x, da, b, c, *, chunk: int = 256, return_state: bool = False, h0=None):
    """Mamba-2 SSD scan over x (BH, S, P), da (BH, S) and b, c (G, S, N)
    from the state ``h0`` (BH, N, P) (zero when None; see
    ``kernels.ssd_scan.ssd_scan``); with ``return_state`` also the final
    state (BH, N, P)."""
    return _ss.ssd_scan(x, da, b, c, chunk=chunk, return_state=return_state, h0=h0)
