"""Fused base + LoRA projection: the CUDA kernels and their wrappers.

Replaces the Pallas TPU kernels ``src/repro/kernels/lora_matmul.py::
lora_matmul`` (one adapter) and ``::gathered_lora_matmul`` (a pool of
adapters, one slot per row):

    y[m] = x[m] @ W + scale * (x[m] @ A[s_m]) @ B[s_m]

Both wrappers launch the same kernels of ``csrc/lora_matmul.cu``: a block
per few rows takes x @ A at the real rank and a tiled kernel computes x @ W
with the correction in its epilogue (splitting K across blocks when the
output has too few tiles to fill the card, as at decode).

Under autograd (an input that requires a gradient, grad mode on) both
wrappers run through ``_LoraFn``: the forward is the same kernel (the plain
version on the CPU), the backward plain PyTorch (``_lora_backward``), as the
reference has no backward kernel.  W is frozen and gets no gradient.  ``route`` says
which base product a call takes: bf16 with 16-byte row strides runs on the
tensor cores (TMA-fed ``wgmma``), everything else on fp32 FMA.  Every row
reads its own slot, so rows are never sorted or padded into single-adapter
tiles and the reference's ``segment_layout`` has no counterpart here (see
the source note).  A pool is handed over with its slot stride: a layer's
slice ``pool[:, layer]`` of a ``(n_slots, n_layers, K, R)`` pool is used in
place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref

_C = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: Widest adapter rank the kernel takes.
MAX_RANK = 64
_TYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = backend.load_library("lora_matmul")
    lib.repro_lora_matmul.argtypes = (
        [_C] * 8 + [_I] * 5 + [_LL, _LL, ctypes.c_float, _I, _I, _I, _C]
    )
    lib.repro_lora_matmul.restype = _I
    lib.repro_lora_rank_width.argtypes = [_I]
    lib.repro_lora_rank_width.restype = _I
    lib.repro_lora_splits.argtypes = [_I] * 4
    lib.repro_lora_splits.restype = _I
    return lib


def route(k: int, n: int, dtype: torch.dtype, *, aligned: bool = True) -> str:
    """The base product's route for an (M, K) @ (K, N) call with activations
    of ``dtype``: ``"tensor"`` (TMA loads and bf16 ``wgmma``) for bfloat16
    when every TMA row stride is a multiple of 16 bytes (K and N positive
    multiples of 8) and the operands are ``aligned`` (see ``_aligned``);
    ``"scalar"`` (fp32 FMA) for float32, whose products TF32 would not
    hold to the float32 checks, and for a ragged bfloat16 shape."""
    if dtype not in _TYPES:
        raise TypeError(f"lora_matmul takes float32 or bfloat16 on CUDA, got {dtype}")
    if dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and n % 8 == 0 and aligned:
        return "tensor"
    return "scalar"


def k_splits(m: int, n: int, k: int, route_name: str) -> int:
    """How many blocks share the K range of an (M, K) @ (K, N) call on
    route ``route_name``: more than one only where the output tiles leave
    the card short of blocks (decode), the splits then added in order by a
    second kernel.  Builds the kernels on first use."""
    return _lib().repro_lora_splits(m, n, k, int(route_name == "tensor"))


def _aligned(x, w, b) -> bool:
    """TMA reads x and W from 16-byte aligned bases; the tensor route's
    epilogue reads B in pairs of columns."""
    pair = 2 * b.element_size()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and b.data_ptr() % pair == 0
            and b.stride(0) % 2 == 0)


def _check_pool_layout(name, t, inner):
    """Pool slices must be contiguous within a slot; the slot stride is free."""
    if t.stride(-1) != 1 or t.stride(-2) != inner:
        raise ValueError(f"{name}: each slot of the pool must be contiguous, got strides "
                         f"{t.stride()} for shape {tuple(t.shape)}")


def _launch(x, w, a, b, row_slot, scale, name):
    m, k = x.shape
    n = w.shape[1]
    n_slots, _, r = a.shape
    if x.dtype not in _TYPES or a.dtype not in _TYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 on CUDA, got x {x.dtype}, "
                        f"adapter {a.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: W is {w.dtype}, x is {x.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"{name}: A is {a.dtype}, B is {b.dtype}")
    if r > MAX_RANK:
        raise ValueError(f"{name}: rank {r} > {MAX_RANK}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} takes contiguous x and W on CUDA")
    _check_pool_layout(name, a, r)
    _check_pool_layout(name, b, n)
    tensors = [x, w, a, b] + ([] if row_slot is None else [row_slot])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    if row_slot is not None and (row_slot.dtype != torch.int32 or not row_slot.is_contiguous()):
        raise TypeError(f"{name}: row_slot must be contiguous int32")
    if max(m, k, n) >= 2**31:
        raise ValueError(f"{name}: dimension too large for the kernel")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y, None
    tensor = route(k, n, x.dtype, aligned=_aligned(x, w, b)) == "tensor"
    lib = _lib()
    xa = torch.empty((m, lib.repro_lora_rank_width(r)), dtype=torch.float32, device=x.device)
    splits = lib.repro_lora_splits(m, n, k, int(tensor))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.repro_lora_matmul(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if row_slot is None else row_slot.data_ptr(), xa.data_ptr(),
            None if partial is None else partial.data_ptr(), y.data_ptr(),
            m, n, k, r, n_slots, a.stride(0), b.stride(0), float(scale),
            int(x.dtype == torch.bfloat16), int(a.dtype == torch.bfloat16), int(tensor),
            backend.stream_ptr(x),
        )
    backend.check_launch(err, name)
    return y, tensor


def _count(fn, tensor):
    """One launch of ``fn``'s kernel on the tensor (True) or scalar route;
    an empty output (None) launches nothing."""
    if tensor is None:
        return
    fn.launches += 1
    fn.tc_launches += int(tensor)


def _check_shapes(x, w, a, b, name):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and W {tuple(w.shape)} do not chain")
    k, n = w.shape
    if a.shape[-2] != k or b.shape[-1] != n or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{name}: adapter A {tuple(a.shape)}, B {tuple(b.shape)} do not fit "
                         f"W {tuple(w.shape)}")


def _lora_forward(x, w, a, b, row_slot, scale):
    """The kernel of ``lora_matmul`` (``row_slot`` None, a 2-D adapter) or of
    ``gathered_lora_matmul``; the plain version for CPU tensors."""
    if row_slot is None:
        if not backend.use_kernel(x):
            return ref.lora_matmul_ref(x, w, a, b, scale)
        y, tensor = _launch(x, w, a[None], b[None], None, scale, "lora_matmul")
        _count(lora_matmul, tensor)
        return y
    if not backend.use_kernel(x):
        return ref.gathered_lora_matmul_ref(x, w, a, b, row_slot, scale)
    y, tensor = _launch(x, w, a, b, row_slot, scale, "gathered_lora_matmul")
    _count(gathered_lora_matmul, tensor)
    return y


def _lora_backward(g, x, w, a, b, row_slot, scale, need):
    """Gradients of ``_lora_forward`` for (x, A, B) in plain PyTorch, each
    None unless ``need`` asks for it.

    It mirrors the autograd of the plain version with one difference: the
    base part g W^T is taken in x's dtype, as the reference's autodiff of a
    bf16 product is (exact in float32).  Everything else is fp32: the
    adapter is rounded to x's dtype (the model's cast), x A is rounded to
    x's dtype before the B product as the forward rounds it, and the
    gradient of x A is rounded there too.  For a pool, slot s takes the
    rows that name it (``row_slot`` None: one adapter for every row):
    dB_s = s (x A_s)^T g_s, dA_s = x^T (s g_s B_s^T), summed over those
    rows; slot -1 rows contribute nothing."""
    need_x, need_a, need_b = need
    dt = x.dtype
    gf = g.float()
    xf = x.float()
    two_d = a.ndim == 2
    pool_a, pool_b = (a[None], b[None]) if two_d else (a, b)
    dx = (g @ w.to(dt).T).float() if need_x else None
    da = torch.zeros(pool_a.shape, dtype=a.dtype, device=a.device) if need_a else None
    db = torch.zeros(pool_b.shape, dtype=b.dtype, device=b.device) if need_b else None
    for s in range(pool_a.shape[0]):
        a_s = pool_a[s].to(dt).float()
        b_s = pool_b[s].to(dt).float()
        gl = scale * gf if row_slot is None else scale * gf * (row_slot == s)[:, None]
        if need_b:
            xa = (xf @ a_s).to(dt).float()
            db[s] = (xa.T @ gl).to(dt).to(b.dtype)
        if need_a or need_x:
            dxa = (gl @ b_s.T).to(dt).float()
            if need_a:
                da[s] = (xf.T @ dxa).to(dt).to(a.dtype)
            if need_x:
                dx = dx + dxa @ a_s.T
    if two_d:
        da = None if da is None else da[0]
        db = None if db is None else db[0]
    return (None if dx is None else dx.to(dt)), da, db


class _LoraFn(torch.autograd.Function):
    """The fused LoRA product with a plain-PyTorch backward."""

    @staticmethod
    def forward(ctx, x, w, a, b, row_slot, scale):
        ctx.save_for_backward(x, w, a, b, row_slot)
        ctx.scale = scale
        return _lora_forward(x, w, a, b, row_slot, scale)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, row_slot = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], ctx.needs_input_grad[2], ctx.needs_input_grad[3])
        dx, da, db = _lora_backward(g, x, w, a, b, row_slot, ctx.scale, need)
        return dx, None, da, db, None, None


def lora_matmul(x, w, a, b, scale: float = 1.0) -> torch.Tensor:
    """y = x @ W + scale * (x @ A) @ B for x (M, K), W (K, N), A (K, R),
    B (R, N).  x and W are float32 or bfloat16 of one type; A and B are
    float32 or bfloat16 and are rounded to x's type.  CPU tensors compute
    ``ref.lora_matmul_ref``; CUDA tensors launch the kernel.  Differentiable
    in x, A and B (``_LoraFn``)."""
    _check_shapes(x, w, a, b, "lora_matmul")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("lora_matmul takes a 2-D adapter; use gathered_lora_matmul for a pool")
    if backend.needs_grad(x, a, b):
        return _LoraFn.apply(x, w, a, b, None, scale)
    return _lora_forward(x, w, a, b, None, scale)


def gathered_lora_matmul(x, w, a_pool, b_pool, row_slot, scale: float = 1.0) -> torch.Tensor:
    """Per-row adapters: y[m] = x[m] @ W + scale * (x[m] @ A[s]) @ B[s] with
    s = row_slot[m], for pools A (n_slots, K, R) and B (n_slots, R, N).
    ``row_slot`` is (M,) int32; slot -1 gives the base projection only, the
    same bits as an all-zero adapter.  Each slot of a pool is contiguous;
    the slot stride is free.  CPU tensors compute
    ``ref.gathered_lora_matmul_ref``; CUDA tensors launch the kernel, which
    traps on a slot outside [-1, n_slots).  Differentiable in x and the
    pools (``_LoraFn``)."""
    _check_shapes(x, w, a_pool, b_pool, "gathered_lora_matmul")
    if a_pool.ndim != 3 or b_pool.ndim != 3 or a_pool.shape[0] != b_pool.shape[0]:
        raise ValueError(f"gathered_lora_matmul: pools {tuple(a_pool.shape)} and "
                         f"{tuple(b_pool.shape)} are not (n_slots, K, R) and (n_slots, R, N)")
    if row_slot.shape != (x.shape[0],):
        raise ValueError(f"row_slot {tuple(row_slot.shape)} is not ({x.shape[0]},)")
    if backend.needs_grad(x, a_pool, b_pool):
        return _LoraFn.apply(x, w, a_pool, b_pool, row_slot, scale)
    return _lora_forward(x, w, a_pool, b_pool, row_slot, scale)


#: Kernel launches since the count was last set to 0 (plain version
#: excluded): all of them, and those of the tensor route.
for _fn in (lora_matmul, gathered_lora_matmul):
    _fn.launches = _fn.tc_launches = 0
