"""Elementwise soft threshold: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel
``src/repro/kernels/soft_threshold.py::soft_threshold``,
sign(x) * max(|x| - t, 0) over a 2-D array with a scalar t.  The kernel
(``csrc/soft_threshold.cu``) shares ``tail_common.cuh::shrink`` with the
ADMM tails and is bound by device-memory bytes: one read and one write of
each element.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref


def _lib():
    lib = backend.load_library("soft_threshold")
    lib.repro_soft_threshold.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.repro_soft_threshold.restype = ctypes.c_int
    return lib


def soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    """sign(x) * max(|x| - t, 0) over a 2-D ``x``, in x's dtype.

    ``t`` is a Python number or a 0-d tensor, rounded to x's dtype first as
    the reference rounds its threshold block.  CPU tensors compute
    ``ref.soft_threshold_ref``.  CUDA tensors (contiguous float32 or
    bfloat16) launch the kernel; a 0-d CUDA ``t`` is read on the card,
    never copied to the host.
    """
    if x.ndim != 2:
        raise ValueError(f"expected 2-D input, got {tuple(x.shape)}")
    if torch.is_tensor(t) and t.ndim != 0:
        raise ValueError(f"t must be a scalar, got shape {tuple(t.shape)}")
    if not backend.use_kernel(x):
        return ref.soft_threshold_ref(x, torch.as_tensor(t, dtype=x.dtype).to(x.device))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"soft_threshold takes float32 or bfloat16 on CUDA, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("soft_threshold takes a contiguous tensor on CUDA")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    t_ptr, t_val = None, 0.0
    if torch.is_tensor(t) and t.device.type == "cuda":
        if t.device != x.device:
            raise ValueError(f"soft_threshold: t on {t.device}, x on {x.device}")
        t_dev = t.to(x.dtype).to(torch.float32)
        t_ptr = t_dev.data_ptr()
    else:
        t_val = float(torch.as_tensor(t, dtype=x.dtype, device="cpu"))
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        err = _lib().repro_soft_threshold(x.data_ptr(), out.data_ptr(), x.numel(), t_ptr,
                                          t_val, int(x.dtype == torch.bfloat16), vec,
                                          backend.stream_ptr(x))
    backend.check_launch(err, "soft_threshold")
    soft_threshold.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (plain version excluded).
soft_threshold.launches = 0
