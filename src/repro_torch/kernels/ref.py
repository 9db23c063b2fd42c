"""Plain-PyTorch versions of the hand-written kernels.

Each function is the twin of a jnp oracle in ``src/repro/kernels/ref.py``
and computes what its CUDA kernel computes.  The kernel wrappers take these
for CPU tensors; the tests hold them against the JAX oracles, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch


def soft_threshold_ref(x: torch.Tensor, t) -> torch.Tensor:
    """RPCA shrinkage: sign(x) * max(|x| - t, 0)."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _scalars(m: torch.Tensor, *vals: torch.Tensor):
    return [v.to(m.dtype)[:, None, None] for v in vals]


def _mask(m: torch.Tensor, mask):
    return 1.0 if mask is None else mask.to(m.dtype)[None, None, :]


def rpca_admm_tail_ref(m, l, y, rho, mu, thresh, mask=None):
    """Fused ADMM tail (twin of ``ref.rpca_admm_tail_ref``): S update, dual
    ascent and per-module residual sum of squares over (B, vec, clients)
    buckets.  ``mask`` zeroes inactive client columns of S / new-Y and drops
    them from the residual sums; ``None`` behaves as all-ones."""
    rho_, mu_, th_ = _scalars(m, rho, mu, thresh)
    msk = _mask(m, mask)
    s = soft_threshold_ref(m - l + rho_ * y, th_) * msk
    resid = (m - l - s) * msk
    y_new = (y + mu_ * resid) * msk
    rsq = torch.sum(torch.square(resid.to(torch.float32)), dim=(1, 2))
    return s, y_new, rsq


def svt_subspace_apply_ref(m, s, y, p, rho, mu, thresh, mask=None):
    """Fused subspace-SVT sweep tail (twin of
    ``ref.svt_subspace_apply_ref``): L = (M - S + rho Y) @ P, then the ADMM
    tail, plus the Gram of the next iterate X' = M - S' + rho Y'.  L is left
    unmasked; the bucket driver masks it once at the end."""
    rho_, mu_, th_ = _scalars(m, rho, mu, thresh)
    msk = _mask(m, mask)
    x = m - s + rho_ * y
    low = torch.matmul(x.to(torch.float32), p.to(torch.float32)).to(m.dtype)
    s_new = soft_threshold_ref(m - low + rho_ * y, th_) * msk
    resid = (m - low - s_new) * msk
    y_new = (y + mu_ * resid) * msk
    rsq = torch.sum(torch.square(resid.to(torch.float32)), dim=(1, 2))
    x_next = (m - s_new + rho_ * y_new).to(torch.float32)
    g_next = torch.matmul(x_next.mT, x_next)
    return low, s_new, y_new, rsq, g_next
