"""Fused RPCA ADMM elementwise tail: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/rpca_admm.py::admm_tail``.
One ADMM iteration in gram mode is an SVT (batched eigh + matmuls, left to
``torch.linalg`` / ``torch.matmul``) followed by this tail:

    S     <- shrink(M - L + rho * Y, rho * lam) * mask
    resid  = (M - L - S) * mask
    Y     <- (Y + mu * resid) * mask
    err    = sum(resid^2)            (per module)

The kernel (``csrc/admm_tail.cu``) is bound by device-memory bytes — five
tensors of B*vec*nc*4 bytes against ~10 flops per element — so it reads M,
L, Y once and writes S, Y' once, with per-tile residual partials summed in
tile order by a second pass (no float atomics; see the source note).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import backend, ref

_C = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = backend.load_library("admm_tail")
    lib.repro_admm_tail.argtypes = [_C] * 11 + [_I] * 3 + [_C]
    lib.repro_admm_tail.restype = _I
    lib.repro_admm_tail_tiles.argtypes = [_I, _I]
    lib.repro_admm_tail_tiles.restype = _I
    return lib


def _check(m, l, y, rho, mu, thresh, mask):
    if m.ndim != 3:
        raise ValueError(f"expected (B, vec, clients) input, got {tuple(m.shape)}")
    if m.shape != l.shape or m.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(m.shape)} {tuple(l.shape)} {tuple(y.shape)}")
    b, _, nc = m.shape
    for name, v in (("rho", rho), ("mu", mu), ("thresh", thresh)):
        if v.shape != (b,):
            raise ValueError(f"{name} must have shape {(b,)}, got {tuple(v.shape)}")
    if mask is not None and mask.shape != (nc,):
        raise ValueError(f"mask must have shape {(nc,)}, got {tuple(mask.shape)}")


def admm_tail(
    m: torch.Tensor,
    l: torch.Tensor,
    y: torch.Tensor,
    rho: torch.Tensor,
    mu: torch.Tensor,
    thresh: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused ADMM tail over a (B, vec, n_clients) bucket.

    ``rho``, ``mu``, ``thresh`` are per-module (B,) scalars
    (``thresh = rho * lam``); ``mask`` is an optional (n_clients,) validity
    mask — masked columns of S and Y' are exactly zero and excluded from the
    residual sums, and ``None`` gives the same bits as an all-ones mask.
    Returns (S, Y', resid_sumsq) with resid_sumsq a (B,) float32 tensor.

    CPU tensors compute ``ref.rpca_admm_tail_ref``.  CUDA tensors must be
    contiguous float32 on one device, and launch the kernel.
    """
    _check(m, l, y, rho, mu, thresh, mask)
    if not backend.use_kernel(m):
        return ref.rpca_admm_tail_ref(m, l, y, rho, mu, thresh, mask)
    b, vec, nc = m.shape
    ins = [m, l, y, rho, mu, thresh] + ([] if mask is None else [mask])
    for t in ins:
        if t.device != m.device:
            raise ValueError(f"admm_tail: tensors on {t.device} and {m.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"admm_tail takes float32 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("admm_tail takes contiguous tensors on CUDA")
    if vec * nc + 4096 >= 2**31:
        raise ValueError(f"admm_tail: module of {vec}x{nc} elements is too large")
    s_out = torch.empty_like(m)
    y_out = torch.empty_like(m)
    rsq = torch.empty((b,), dtype=torch.float32, device=m.device)
    if m.numel() == 0:
        return s_out, y_out, rsq.zero_()
    mvec = torch.ones((nc,), dtype=torch.float32, device=m.device) if mask is None else mask
    lib = _lib()
    partial = torch.empty((b, lib.repro_admm_tail_tiles(vec, nc)), dtype=torch.float32,
                          device=m.device)
    with torch.cuda.device(m.device):
        err = lib.repro_admm_tail(
            m.data_ptr(), l.data_ptr(), y.data_ptr(), rho.data_ptr(), mu.data_ptr(),
            thresh.data_ptr(), mvec.data_ptr(), s_out.data_ptr(), y_out.data_ptr(),
            partial.data_ptr(), rsq.data_ptr(), b, vec, nc, backend.stream_ptr(m),
        )
    backend.check_launch(err, "admm_tail")
    admm_tail.launches += 1
    return s_out, y_out, rsq


#: Kernel launches since the count was last set to 0 (plain version excluded).
admm_tail.launches = 0
