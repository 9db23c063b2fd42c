"""Causal sliding-window flash attention: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/local_attention.py::
local_attention``: attention over (BH, S, D) with an fp32 online softmax,
causal, keys limited to the last ``window`` positions when ``window > 0``
(0 = full causal).  The kernel (``csrc/local_attention.cu``) visits only the
key tiles a query tile needs and keeps scores out of device memory; see the
source note.  ``route`` says which of its two routes a call takes: bf16 runs
QK^T and PV as ``wgmma`` on tiles that TMA loads into a ring of stages,
float32 stays on fp32 FMA.  ``tc_plan`` describes the bf16 route's geometry
and the key tiles each query tile and warpgroup visits, as the kernel
computes them.

Under autograd the wrapper runs through ``_AttentionFn``: the forward is the
kernel (the plain version on the CPU); the backward recomputes the plain
version from the saved q, k, v and differentiates it, as the reference has
no backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_C = ctypes.c_void_p
_I = ctypes.c_int

#: Head widths the kernel is built for.
HEAD_DIMS = (32, 64, 128, 256)

#: The bf16 route's geometry by head width: (query rows a block, keys a
#: K / V tile, ring stages, Q buffers).  ``csrc/local_attention.cu``'s
#: ``Geom`` has the same numbers, and static_asserts them with the shared
#: memory of ``tc_smem_bytes``.
TC_GEOM = {32: (128, 128, 3, 2), 64: (128, 128, 3, 2), 128: (128, 128, 2, 2),
           256: (128, 64, 2, 1)}
#: A block's shared memory on the H100 (227 KB).
SMEM_LIMIT = 232448


def tc_smem_bytes(d: int) -> int:
    """Shared memory of one bf16-route block at head width ``d``: the Q
    buffers, the ring of K and V tiles, the barriers (per Q buffer loaded
    and released, per stage K loaded, V loaded, stage released), an item
    slot per Q buffer, and 1024 bytes to align the tiles to the swizzle
    atom."""
    bq, bn, stages, qbufs = TC_GEOM[d]
    return (1024 + qbufs * 2 * bq * d + 2 * stages * 2 * bn * d
            + 8 * (2 * qbufs + 3 * stages) + 8 * qbufs)


def tc_plan(s: int, d: int, window: int, causal: bool) -> dict:
    """The bf16 route's plan for one (S, D) head: ``bq``, ``bn``,
    ``stages``, ``q_buffers`` and ``smem_bytes``, and per query tile of ``bq`` rows (the
    kernel's work items, each run by two warpgroups of 64 rows) its first
    row ``q0`` and the key tiles it loads, ``[t_first, t_first + n_tiles)``;
    per warpgroup its rows ``[lo, lo + 64)``, the tiles it multiplies,
    ``[t_lo, t_hi)`` (every other tile of the query tile is masked for all
    its rows, and it only waits for and hands back those), and the tiles of
    those that it masks entry by entry (``masked``; the rest keep every
    (row < S, key) pair).  Tile indices are absolute: tile t holds keys
    ``[t * bn, (t + 1) * bn)``."""
    bq, bn, stages, qbufs = TC_GEOM[d]
    tiles = []
    for q0 in range(0, s, bq):
        key_last = min(q0 + bq, s) - 1 if causal else s - 1
        t_first = (max(0, q0 - window + 1) if window else 0) // bn
        n_tiles = key_last // bn - t_first + 1
        groups = []
        for lo in (q0, q0 + 64):
            hi = lo + 63
            if lo < s:
                t_lo = (max(0, lo - window + 1) if window else 0) // bn
                t_hi = (min(hi, key_last) if causal else key_last) // bn + 1
            else:
                t_lo = t_hi = t_first
            masked = [t for t in range(t_lo, t_hi)
                      if (causal and t * bn + bn - 1 > lo) or t * bn + bn > s
                      or (window and t * bn <= hi - window)]
            groups.append(dict(lo=lo, t_lo=t_lo, t_hi=t_hi, masked=masked))
        tiles.append(dict(q0=q0, t_first=t_first, n_tiles=n_tiles, warpgroups=groups))
    return dict(bq=bq, bn=bn, stages=stages, q_buffers=qbufs, smem_bytes=tc_smem_bytes(d),
                query_tiles=tiles)


def _lib():
    lib = backend.load_library("local_attention")
    lib.repro_local_attention.argtypes = [_C] * 4 + [_I] * 7 + [_C]
    lib.repro_local_attention.restype = _I
    lib.repro_local_attention_tc_geometry.argtypes = [_I, ctypes.POINTER(_I)]
    lib.repro_local_attention_tc_geometry.restype = _I
    return lib


def tc_geometry(d: int) -> dict:
    """The built bf16 kernel's geometry at head width ``d``, as the CUDA
    library reports it: ``bq``, ``bn``, ``stages``, ``smem_bytes``, the
    registers a thread at launch (``registers``, from the compiled kernel)
    and after ``setmaxnreg`` (``consumer_registers``,
    ``producer_registers``).  Needs the card."""
    out = (_I * 7)()
    backend.check_launch(_lib().repro_local_attention_tc_geometry(d, out),
                         "local_attention geometry")
    keys = ("bq", "bn", "stages", "smem_bytes", "registers", "consumer_registers",
            "producer_registers")
    return dict(zip(keys, list(out)))


def route(d: int, dtype: torch.dtype) -> str:
    """The kernel route for head width ``d`` and ``dtype``: ``"tensor"``
    (bfloat16: QK^T and PV as bf16 tensor-core products, fp32 softmax) or
    ``"scalar"`` (float32: fp32 FMA throughout).  Raises for what neither
    route takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"local_attention takes float32 or bfloat16 on CUDA, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"local_attention: head width {d} not in {HEAD_DIMS}")
    return "tensor" if dtype == torch.bfloat16 else "scalar"


class _AttentionFn(torch.autograd.Function):
    """The attention kernel with a recompute-the-plain-version backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        return _forward(q, k, v, window, causal)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, ctx.needs_input_grad[:3])]
            out = ref.local_attention_ref(*ins, window=ctx.window, causal=ctx.causal)
            want = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, want, g))
        return (*(next(got) if t.requires_grad else None for t in ins), None, None)


def local_attention(q, k, v, *, window: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention over q, k, v of shape (BH, S, D).  CPU tensors compute
    ``ref.local_attention_ref``; CUDA tensors (contiguous float32 or
    bfloat16, D in ``HEAD_DIMS``) launch the kernel by ``route``.
    Differentiable in q, k and v (``_AttentionFn``)."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected three (BH, S, D) tensors, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if backend.needs_grad(q, k, v):
        return _AttentionFn.apply(q, k, v, window, causal)
    return _forward(q, k, v, window, causal)


def _forward(q, k, v, window, causal):
    """The kernel launch, or the plain version for CPU tensors."""
    if not backend.use_kernel(q):
        return ref.local_attention_ref(q, k, v, window=window, causal=causal)
    bh, s, d = q.shape
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("local_attention: q, k, v differ in device or dtype")
    tensor = route(d, q.dtype) == "tensor"
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("local_attention takes contiguous tensors on CUDA")
    if tensor and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("local_attention: the tensor route reads q, k and v by TMA, which "
                         "needs them to start 16-byte aligned")
    if bh > 65535 or bh * s * d >= 2**62:
        raise ValueError(f"local_attention: {bh} rows of {s} x {d} exceed the launch grid")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _lib().repro_local_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
            int(window), int(bool(causal)), int(q.dtype == torch.bfloat16), int(tensor),
            backend.stream_ptr(q),
        )
    backend.check_launch(err, "local_attention")
    local_attention.launches += 1
    local_attention.tc_launches += int(tensor)
    return out


#: Kernel launches since the count was last set to 0 (plain version
#: excluded): all of them, and those of the tensor route.
local_attention.launches = 0
local_attention.tc_launches = 0
