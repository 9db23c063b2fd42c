"""Mamba-2 SSD chunked scan: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan``:
the selective-state recurrence h_t = exp(da_t) h_{t-1} + B_t^T x_t,
y_t = C_t h_t over (BH, S) rows, in the chunked dual form (intra-chunk
``(L o C B^T) x`` plus the carried state).  The kernel
(``csrc/ssd_scan.cu``) also writes the final state, which prefill hands to
decode, and starts from a given state ``h0`` (the model's ``h_init``) when
there is one.  A first pass writes each group's C B^T score tiles and the
in-tile sums of da once; the scan runs its three products on the tensor
cores in 3xTF32 (fp32-level accuracy, never a single TF32 pass) with h in
the accumulator fragments; see the source note for its tiling.

Under autograd the wrapper runs through ``_SSDScanFn``: the forward is the
kernel (the plain sequential scan on the CPU); the backward recomputes the
plain chunked form (``ref.ssd_chunked_ref``) from the saved inputs and
differentiates it, as the reference has no backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_C = ctypes.c_void_p
_I = ctypes.c_int

#: Largest state width N the kernel is built for.
MAX_STATE = 128
#: Positions per tile (``csrc/ssd_scan.cu``).
TILE = 64


def scratch_floats(bh: int, s: int, groups: int) -> int:
    """Scratch of one call, in floats: the (G, tiles, 64, 64) score tiles
    and the (BH, tiles * 64) in-tile sums of da."""
    tiles = -(-s // TILE)
    return tiles * TILE * (groups * TILE + bh)


def _lib():
    lib = backend.load_library("ssd_scan")
    lib.repro_ssd_scan.argtypes = [_C] * 8 + [_I] * 6 + [_C]
    lib.repro_ssd_scan.restype = _I
    return lib


def _check(x, da, b, c, chunk, h0=None):
    if x.ndim != 3 or da.shape != x.shape[:2]:
        raise ValueError(f"expected x (BH, S, P) and da (BH, S), got {tuple(x.shape)} "
                         f"{tuple(da.shape)}")
    if b.ndim != 3 or b.shape != c.shape or b.shape[1] != x.shape[1]:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} are not (G, S, N) "
                         f"with S = {x.shape[1]}")
    if b.shape[0] < 1 or x.shape[0] % b.shape[0]:
        raise ValueError(f"{b.shape[0]} groups of b and c do not divide {x.shape[0]} rows")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    want = (x.shape[0], b.shape[-1], x.shape[-1])
    if h0 is not None and tuple(h0.shape) != want:
        raise ValueError(f"h0 {tuple(h0.shape)} is not (BH, N, P) = {want}")


class _SSDScanFn(torch.autograd.Function):
    """The SSD scan kernel with a recompute-the-chunked-form backward."""

    @staticmethod
    def forward(ctx, x, da, b, c, h0, chunk, return_state):
        ctx.save_for_backward(x, da, b, c, h0)
        ctx.chunk, ctx.return_state = chunk, return_state
        return _forward(x, da, b, c, chunk, return_state, h0)

    @staticmethod
    def backward(ctx, gy, gh=None):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(saved, ctx.needs_input_grad[:5])]
            outs = ref.ssd_chunked_ref(*ins[:4], ctx.chunk, h0=ins[4], return_state=True)
            pairs = [(o, gr) for o, gr in zip(outs, (gy, gh)) if gr is not None]
            want = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                           [gr for _, gr in pairs]))
        return (*(next(got) if t is not None and t.requires_grad else None for t in ins),
                None, None)


def ssd_scan(x, da, b, c, *, chunk: int = 256, return_state: bool = False, h0=None):
    """y (BH, S, P) of the SSD scan, and with ``return_state`` the final
    state (BH, N, P) in float32.  ``h0`` (BH, N, P) is the state before
    position 0 (zero when None).

    x (BH, S, P) holds the dt-premultiplied inputs, da (BH, S) the
    log-decays; b and c are (G, S, N) with G dividing BH: row bh reads
    group bh // (BH // G), so a single group shared by a batch row's heads
    is read where it lies (G = batch) rather than copied per head.  The
    result does not depend on ``chunk`` in exact arithmetic; the kernel
    tiles by 64 positions.  CPU tensors compute ``ref.ssd_scan_ref``; CUDA
    tensors (contiguous float32, N <= ``MAX_STATE``) launch the kernel.
    Differentiable in x, da, b, c and h0 (``_SSDScanFn``).
    """
    _check(x, da, b, c, chunk, h0)
    if backend.needs_grad(x, da, b, c, *(() if h0 is None else (h0,))):
        return _SSDScanFn.apply(x, da, b, c, h0, chunk, return_state)
    return _forward(x, da, b, c, chunk, return_state, h0)


def _forward(x, da, b, c, chunk, return_state, h0=None):
    """The kernel launch, or the plain scan for CPU tensors."""
    if not backend.use_kernel(x):
        return ref.ssd_scan_ref(x, da, b, c, chunk, h0=h0, return_state=return_state)
    bh, s, p = x.shape
    n = b.shape[-1]
    for t in (da, b, c, *(() if h0 is None else (h0,))):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: tensors on {t.device} and {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan takes float32 on CUDA, got {t.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 on CUDA, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, da, b, c, *(() if h0 is None else (h0,)))):
        raise ValueError("ssd_scan takes contiguous tensors on CUDA")
    if n > MAX_STATE or bh > 65535 or x.numel() >= 2**31 or b.numel() >= 2**31:
        raise ValueError(f"ssd_scan: (BH, S, P, N) = {(bh, s, p, n)} exceeds the kernel")
    y = torch.empty_like(x)
    empty = p == 0 or n == 0 or s == 0  # nothing to scan: y is zero or empty, h zero
    h = None
    if return_state:  # the kernel writes every entry of h
        h = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    if empty:  # no position: the state stays h0
        y.zero_()
        if h is not None and h0 is None:
            h.zero_()
        elif h is not None:
            h.copy_(h0)
        return (y, h) if return_state else y
    scratch = torch.empty((scratch_floats(bh, s, b.shape[0]),), dtype=torch.float32,
                          device=x.device)
    vec4 = n % 4 == 0 and p % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, b, c))
    with torch.cuda.device(x.device):
        err = _lib().repro_ssd_scan(
            x.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            None if h is None else h.data_ptr(), scratch.data_ptr(), bh, s, p, n,
            bh // b.shape[0], int(vec4), backend.stream_ptr(x),
        )
    backend.check_launch(err, "ssd_scan")
    ssd_scan.launches += 1
    return (y, h) if return_state else y


#: Kernel launches since the count was last set to 0 (plain version excluded).
ssd_scan.launches = 0
