"""Mamba-2 SSD chunked scan: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan``:
the selective-state recurrence h_t = exp(da_t) h_{t-1} + B_t^T x_t,
y_t = C_t h_t over (BH, S) rows, in the chunked dual form (intra-chunk
``(L o C B^T) x`` plus the carried state).  The kernel
(``csrc/ssd_scan.cu``) also writes the final state, which prefill hands to
decode, and starts from a given state ``h0`` (the model's ``h_init``) when
there is one.  A first pass writes each group's C B^T score tiles and the
in-tile sums of da once; the scan runs its products as ``wgmma`` on the
tensor cores in 3xTF32 (fp32-level accuracy, never a single TF32 pass): a
producer warpgroup loads tiles by TMA (by cp.async where a row stride is
not a multiple of 16 bytes), one consumer warpgroup runs the half of tile
k + 1 that does not read the state while the other runs tile k's state
carry, with h in its registers; one persistent block an SM walks the
(row, 32 columns) items.  ``plan`` mirrors the geometry; see the source
note for the design.

Under autograd the wrapper runs through ``_SSDScanFn``: the forward is the
kernel (the plain sequential scan on the CPU); the backward recomputes the
plain chunked form (``ref.ssd_chunked_ref``) from the saved inputs and
differentiates it, as the reference has no backward kernel; while tracing
(``utils.trace``) it is the span ``repro.ssd.backward``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref
from repro_torch.utils import trace

_C = ctypes.c_void_p
_I = ctypes.c_int

#: Largest state width N the kernel is built for.
MAX_STATE = 128
#: Positions per tile (``csrc/ssd_scan.cu``).
TILE = 64
#: Columns of P a work item of the scan takes.
COLS = 32
#: Threads of a scan block: the h-bound, h-free and producer warpgroups.
THREADS = 384
#: A scan block's shared memory: two stages of the free ring (B, x, scores:
#: 57344 bytes each, and each stage's x^T lo, 8192, and sums, 256), two of
#: the bound ring (C, 32768 each), h^T hi and lo (32768), 10 mbarriers, and
#: 1024 bytes of slack to align the swizzled boxes.
SCAN_SMEM = 1024 + 2 * (57344 + 8192 + 256) + 2 * 32768 + 32768 + 8 * 10
#: A block's shared memory on the H100 (227 KB), and its SMs.
SMEM_LIMIT = 232448
SMS = 132


def plan(bh: int, s: int, p: int, n: int, groups: int, aligned: bool = True) -> dict:
    """The kernel's geometry for one call, as ``csrc/ssd_scan.cu`` takes it:
    the scan's work ``items`` (a row and 32 columns of P each), its
    persistent ``grid`` of one block an SM (``blocks_per_sm``: its
    ``smem_bytes`` leave no room for a second) that walks them round by
    round, the rounds (``waves``) on the H100's 132 SMs and the share of
    the SMs the last one fills (``last_wave_fill``), the first pass's
    ``prep_grid`` (tiles, groups, 2 halves of a tile's key rows), ``tiles``,
    the 32-wide ``boxes`` of N that the loads and inter visit, and the
    loads' ``route``: ``"tma"`` when N and P are multiples of 4 and x, B and
    C 16-byte ``aligned``, else ``"cp.async"``."""
    tiles = -(-s // TILE)
    items = -(-p // COLS) * bh
    per_sm = SMEM_LIMIT // SCAN_SMEM
    slots = per_sm * SMS
    last = items - (-(-items // slots) - 1) * slots
    return dict(items=items, grid=(min(items, slots),), threads=THREADS, smem_bytes=SCAN_SMEM,
                blocks_per_sm=per_sm, waves=items / slots, last_wave_fill=last / slots,
                prep_grid=(tiles, groups, 2), tiles=tiles, boxes=-(-n // 32),
                route="tma" if _tma_loads(p, n, aligned) else "cp.async")


def _tma_loads(p: int, n: int, aligned: bool) -> bool:
    """TMA takes a tensor whose rows are a multiple of 16 bytes and whose
    base is 16-byte aligned; the kernel's ``vec4``."""
    return n % 4 == 0 and p % 4 == 0 and aligned


def scratch_floats(bh: int, s: int, groups: int) -> int:
    """Scratch of one call, in floats: the (G, tiles, 64, 64) score tiles
    and the (BH, tiles * 64) in-tile sums of da."""
    tiles = -(-s // TILE)
    return tiles * TILE * (groups * TILE + bh)


def _lib():
    lib = backend.load_library("ssd_scan")
    lib.repro_ssd_scan.argtypes = [_C] * 8 + [_I] * 6 + [_C]
    lib.repro_ssd_scan.restype = _I
    lib.repro_ssd_scan_geometry.argtypes = [ctypes.POINTER(_I)]
    lib.repro_ssd_scan_geometry.restype = _I
    return lib


def geometry() -> dict:
    """The built scan kernel's geometry, as the CUDA library reports it:
    ``tile``, ``cols``, ``threads``, ``smem_bytes``, ``registers`` a thread
    at launch (from the compiled kernel) and after setmaxnreg
    (``consumer_registers``, ``producer_registers``), ``blocks_per_sm`` (the
    occupancy calculator's) and the first pass's ``prep_smem_bytes``."""
    out = (_I * 9)()
    backend.check_launch(_lib().repro_ssd_scan_geometry(out), "ssd_scan geometry")
    keys = ("tile", "cols", "threads", "smem_bytes", "registers", "consumer_registers",
            "producer_registers", "blocks_per_sm", "prep_smem_bytes")
    return dict(zip(keys, out))


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
        with trace.span("repro.ssd.backward"), torch.enable_grad():
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
    # The first pass's grid takes the groups on its y dimension.
    if n > MAX_STATE or b.shape[0] > 65535 or x.numel() >= 2**31 or b.numel() >= 2**31:
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
    vec4 = _tma_loads(p, n, all(t.data_ptr() % 16 == 0 for t in (x, b, c)))
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
