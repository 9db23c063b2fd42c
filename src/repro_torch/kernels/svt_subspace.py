"""Fused subspace-SVT sweep tails: the CUDA kernels and their wrappers.

``subspace_apply`` replaces the Pallas TPU kernel
``src/repro/kernels/svt_subspace.py::subspace_apply``.  In subspace SVT
mode one ADMM iteration is the small-matrix algebra that yields the
(B, d2, d2) shrink projector P (power sweeps, CholeskyQR, Rayleigh-Ritz —
left to ``torch.linalg`` / ``torch.matmul``) followed by this tail over the
tall (B, vec, d2) bucket:

    X     = M - S + rho * Y
    L     = X @ P
    S'    = shrink(M - L + rho * Y, rho * lam) * mask
    resid = (M - L - S') * mask
    Y'    = (Y + mu * resid) * mask
    err   = sum(resid^2)                  (per module)
    G'    = X'^T X',  X' = M - S' + rho * Y'

The kernel (``csrc/subspace_apply.cu``) is bound by device-memory bytes —
six bucket tensors plus P and G' — and keeps X and X' in shared memory; the
Gram and residual partials of its row groups are summed in group order by a
second pass (no float atomics; see the source note).  ``route`` says which
of its two routes a cohort width takes: for 1 <= d2 <= 128 both products
run on the tensor cores in 3xTF32 (three TF32 passes over a hi/lo split,
fp32-level accuracy, never a single TF32 pass) with a cp.async ring of
64-row tiles; wider cohorts keep the fp32 FMA route.

``subspace_apply_factored`` replaces the Pallas TPU kernel
``src/repro/kernels/svt_subspace.py::subspace_apply_factored``: the tail of
one client shard of the mesh-sharded loop (``core/rpca.py``), which rebuilds
its own columns L = F Vr^T from the replicated (B, vec, r) shrink factor and
the shard's (B, d2, r) Ritz basis rows, so no d2 x d2 projector exists, and
returns the shard's partial residual sum (no Gram).  Its kernel
(``csrc/subspace_apply_factored.cu``) is bound by device-memory bytes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import backend, ref

_C = ctypes.c_void_p
_I = ctypes.c_int

#: Shared-memory budget of one block, in floats (192 KiB of the 227 KiB a
#: Hopper block may use).
SMEM_FLOATS = 48 * 1024
#: Rows of X a block stages per tile, at most.
MAX_TILE_ROWS = 32
#: Widest column tile of P staged at once; wider cohorts read P in tiles.
MAX_PCOLS = 128
#: Blocks the launch aims for (four per SM of an H100's 132).
TARGET_BLOCKS = 4 * 132
#: Scratch budget of the Gram partials, in floats (256 MiB).
SCRATCH_FLOATS = 1 << 26
#: Elements of M a block of the factored kernel walks (16 per thread).
FACTORED_TILE_ELEMS = 4096
#: Widest cohort of the tensor route, and the padded widths it is built for.
TC_MAX_D2 = 128
TC_WIDTHS = (8, 16, 32, 48, 64, 96, 128)
#: Shared memory of one H100 SM and of one block, in bytes, and the SM count
#: the tensor route's row groups are sized for (fixed, so a launch's
#: partition, and its bits, do not depend on the card it runs on).
SM_SMEM_BYTES = 233472
BLOCK_SMEM_BYTES = 232448
SM_COUNT = 132


def _lib():
    lib = backend.load_library("subspace_apply")
    lib.repro_subspace_apply.argtypes = [_C] * 15 + [_I] * 7 + [_C]
    lib.repro_subspace_apply.restype = _I
    lib.repro_subspace_apply_tc.argtypes = [_C] * 15 + [_I] * 7 + [_C]
    lib.repro_subspace_apply_tc.restype = _I
    return lib


def route(d2: int) -> str:
    """The kernel route for cohort width ``d2``: ``"tensor"`` (1 <= d2 <=
    ``TC_MAX_D2``: both products on the tensor cores in 3xTF32) or
    ``"scalar"`` (wider: fp32 FMA).  The shape alone decides."""
    if d2 < 1:
        raise ValueError(f"subspace_apply: cohort width {d2} < 1")
    return "tensor" if d2 <= TC_MAX_D2 else "scalar"


def tc_tiling(n_modules: int, vec: int, d2: int) -> dict:
    """Launch geometry of the tensor route: the padded width ``dn``, rows
    per tile, shared bytes of one block, blocks an SM, rows per group and
    the number of row groups (one block per group and module).  Groups are
    sized so that all blocks of a launch are resident in one wave where the
    module count allows it.  Mirrors ``csrc/subspace_apply.cu``'s
    ``TcGeo`` and ``tc_smem_floats``."""
    if route(d2) != "tensor":
        raise ValueError(f"subspace_apply: d2={d2} is past the tensor route")
    dn = next(w for w in TC_WIDTHS if w >= d2)
    rows = 64 if dn <= 64 else 32
    dm = -(-dn // 16) * 16
    sw, sx = dm + 8, dn + 4
    p_copies = 2 if dn <= 64 else 1  # P's TF32 hi and lo halves, or P
    smem = 4 * (6 * rows * d2 + p_copies * dn * sw + rows * sx + rows * sw + dn)
    per_sm = min(2 if dn <= 48 else 1, SM_SMEM_BYTES // (smem + 1024))
    n_tiles = -(-vec // rows)
    cap = max(1, SCRATCH_FLOATS // max(1, n_modules * d2 * d2))
    n_groups = max(1, min(n_tiles, cap, SM_COUNT * per_sm // max(n_modules, 1)))
    group_rows = -(-n_tiles // n_groups) * rows
    n_groups = -(-vec // group_rows)
    return dict(dn=dn, tile_rows=rows, smem=smem, blocks_per_sm=per_sm,
                group_rows=group_rows, n_groups=n_groups)


def _factored_lib():
    lib = backend.load_library("subspace_apply_factored")
    lib.repro_subspace_apply_factored.argtypes = [_C] * 13 + [_I] * 6 + [_C]
    lib.repro_subspace_apply_factored.restype = _I
    return lib


def tiling(n_modules: int, vec: int, d2: int) -> dict:
    """Launch geometry for a (n_modules, vec, d2) bucket: rows per tile,
    P columns per tile, rows per group and the number of row groups (one
    block per group and module).  Raises when d2 is too wide for the
    shared-memory budget."""
    pcols = min(d2, MAX_PCOLS)
    while pcols > 8 and d2 * pcols + 3 * d2 > SMEM_FLOATS:
        pcols //= 2
    tile_rows = min(MAX_TILE_ROWS, (SMEM_FLOATS - d2 * pcols - d2) // (2 * d2))
    if tile_rows < 1:
        raise ValueError(f"subspace_apply: cohort width d2={d2} is too wide for the kernel")
    n_tiles = -(-vec // tile_rows)
    # Gram partials are n_modules * n_groups * d2^2 floats: keep them <= 256 MiB.
    cap = max(1, SCRATCH_FLOATS // max(1, n_modules * d2 * d2))
    n_groups = max(1, min(n_tiles, cap, -(-TARGET_BLOCKS // max(n_modules, 1))))
    group_rows = -(-n_tiles // n_groups) * tile_rows
    n_groups = -(-vec // group_rows)
    return dict(tile_rows=tile_rows, pcols=pcols, group_rows=group_rows, n_groups=n_groups)


def _check(m, s, y, p, rho, mu, thresh, mask):
    if m.ndim != 3:
        raise ValueError(f"expected (B, vec, clients) input, got {tuple(m.shape)}")
    if m.shape != s.shape or m.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(m.shape)} {tuple(s.shape)} {tuple(y.shape)}")
    b, _, d2 = m.shape
    if p.shape != (b, d2, d2):
        raise ValueError(f"projector shape {tuple(p.shape)} != {(b, d2, d2)}")
    for name, v in (("rho", rho), ("mu", mu), ("thresh", thresh)):
        if v.shape != (b,):
            raise ValueError(f"{name} must have shape {(b,)}, got {tuple(v.shape)}")
    if mask is not None and mask.shape != (d2,):
        raise ValueError(f"mask must have shape {(d2,)}, got {tuple(mask.shape)}")


def subspace_apply(
    m: torch.Tensor,
    s: torch.Tensor,
    y: torch.Tensor,
    p: torch.Tensor,
    rho: torch.Tensor,
    mu: torch.Tensor,
    thresh: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
):
    """Fused subspace-SVT ADMM iteration tail over a (B, vec, d2) bucket.

    ``p`` is the (B, d2, d2) shrink projector; ``rho``, ``mu``, ``thresh``
    are per-module (B,) scalars; ``mask`` an optional (d2,) validity mask
    (masked columns of S'/Y' exactly zero and out of the residual sums,
    ``None`` the same bits as all-ones).  L is not masked.  Returns
    (L, S', Y', resid_sumsq, G') with resid_sumsq (B,) and G' (B, d2, d2)
    float32.

    CPU tensors compute ``ref.svt_subspace_apply_ref``.  CUDA tensors must
    be contiguous float32 on one device, and launch the kernel by
    ``route``.
    """
    _check(m, s, y, p, rho, mu, thresh, mask)
    if not backend.use_kernel(m):
        return ref.svt_subspace_apply_ref(m, s, y, p, rho, mu, thresh, mask)
    b, vec, d2 = m.shape
    ins = [m, s, y, p, rho, mu, thresh] + ([] if mask is None else [mask])
    for t in ins:
        if t.device != m.device:
            raise ValueError(f"subspace_apply: tensors on {t.device} and {m.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"subspace_apply takes float32 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("subspace_apply takes contiguous tensors on CUDA")
    l_out = torch.empty_like(m)
    s_out = torch.empty_like(m)
    y_out = torch.empty_like(m)
    rsq = torch.empty((b,), dtype=torch.float32, device=m.device)
    g_out = torch.empty((b, d2, d2), dtype=torch.float32, device=m.device)
    if m.numel() == 0:
        return l_out, s_out, y_out, rsq.zero_(), g_out.zero_()
    tensor = route(d2) == "tensor"
    geo = tc_tiling(b, vec, d2) if tensor else tiling(b, vec, d2)
    mvec = torch.ones((d2,), dtype=torch.float32, device=m.device) if mask is None else mask
    r_part = torch.empty((b, geo["n_groups"]), dtype=torch.float32, device=m.device)
    g_part = torch.empty((b, geo["n_groups"], d2, d2), dtype=torch.float32, device=m.device)
    ptrs = (m.data_ptr(), s.data_ptr(), y.data_ptr(), p.data_ptr(), rho.data_ptr(),
            mu.data_ptr(), thresh.data_ptr(), mvec.data_ptr(), l_out.data_ptr(),
            s_out.data_ptr(), y_out.data_ptr(), r_part.data_ptr(), g_part.data_ptr(),
            rsq.data_ptr(), g_out.data_ptr())
    lib = _lib()
    with torch.cuda.device(m.device):
        if tensor:
            vec4 = (vec * d2) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (m, s, y))
            err = lib.repro_subspace_apply_tc(
                *ptrs, b, vec, d2, geo["dn"], geo["group_rows"], geo["n_groups"], int(vec4),
                backend.stream_ptr(m),
            )
        else:
            err = lib.repro_subspace_apply(
                *ptrs, b, vec, d2, geo["tile_rows"], geo["pcols"], geo["group_rows"],
                geo["n_groups"], backend.stream_ptr(m),
            )
    backend.check_launch(err, "subspace_apply")
    subspace_apply.launches += 1
    subspace_apply.tc_launches += int(tensor)
    return l_out, s_out, y_out, rsq, g_out


#: Kernel launches since the count was last set to 0 (plain version
#: excluded), and those of them on the tensor route.
subspace_apply.launches = 0
subspace_apply.tc_launches = 0


def factored_tiling(vec: int, d2: int, r: int) -> dict:
    """Launch geometry of the factored kernel: rows per tile (one block per
    tile and module) and the number of tiles.  It depends on the shard's
    shape only, never on the module count.  Raises when the basis rows do
    not fit the shared-memory budget."""
    room = SMEM_FLOATS - d2 * r - d2
    tile_rows = min(max(vec, 1), max(1, FACTORED_TILE_ELEMS // d2), room // max(r, 1))
    if tile_rows < 1:
        raise ValueError(f"subspace_apply_factored: basis ({d2}, {r}) is too wide for the kernel")
    return dict(tile_rows=tile_rows, n_groups=-(-vec // tile_rows))


def _check_factored(m, y, f, vr, rho, mu, thresh, mask):
    if m.ndim != 3:
        raise ValueError(f"expected (B, vec, clients) input, got {tuple(m.shape)}")
    if m.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(m.shape)} {tuple(y.shape)}")
    b, d1, d2 = m.shape
    r = f.shape[-1]
    if f.shape != (b, d1, r):
        raise ValueError(f"factor shape {tuple(f.shape)} != {(b, d1, r)}")
    if vr.shape != (b, d2, r):
        raise ValueError(f"basis shape {tuple(vr.shape)} != {(b, d2, r)}")
    for name, v in (("rho", rho), ("mu", mu), ("thresh", thresh)):
        if v.shape != (b,):
            raise ValueError(f"{name} must have shape {(b,)}, got {tuple(v.shape)}")
    if mask is not None and mask.shape != (d2,):
        raise ValueError(f"mask must have shape {(d2,)}, got {tuple(mask.shape)}")


def subspace_apply_factored(
    m: torch.Tensor,
    y: torch.Tensor,
    f: torch.Tensor,
    vr: torch.Tensor,
    rho: torch.Tensor,
    mu: torch.Tensor,
    thresh: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
):
    """Factored-projector SVT tail of one client shard: L = F Vr^T, then
    the shrink, dual and residual tail.

    ``m``, ``y`` are the shard's (B, vec, d2) columns, ``f`` the replicated
    (B, vec, r) shrink factor (X Vr) diag(coef), ``vr`` the shard's
    (B, d2, r) Ritz basis rows; ``rho``, ``mu``, ``thresh`` per-module (B,)
    scalars; ``mask`` the shard's optional (d2,) column mask (masked
    columns of S'/Y' exactly zero and out of the residual sums, ``None`` the
    same bits as all-ones).  L is not masked.  Returns (L, S', Y',
    resid_sumsq) with resid_sumsq the (B,) float32 partial of these columns;
    the caller sums the shards' partials.

    CPU tensors compute ``ref.svt_subspace_apply_factored_ref``.  CUDA
    tensors must be contiguous float32 on one device, and launch the kernel.
    """
    _check_factored(m, y, f, vr, rho, mu, thresh, mask)
    if not backend.use_kernel(m):
        return ref.svt_subspace_apply_factored_ref(m, y, f, vr, rho, mu, thresh, mask)
    b, vec, d2 = m.shape
    r = f.shape[-1]
    ins = [m, y, f, vr, rho, mu, thresh] + ([] if mask is None else [mask])
    for t in ins:
        if t.device != m.device:
            raise ValueError(f"subspace_apply_factored: tensors on {t.device} and {m.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"subspace_apply_factored takes float32 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("subspace_apply_factored takes contiguous tensors on CUDA")
    l_out = torch.empty_like(m)
    s_out = torch.empty_like(m)
    y_out = torch.empty_like(m)
    rsq = torch.empty((b,), dtype=torch.float32, device=m.device)
    if m.numel() == 0:
        return l_out, s_out, y_out, rsq.zero_()
    geo = factored_tiling(vec, d2, r)
    mvec = torch.ones((d2,), dtype=torch.float32, device=m.device) if mask is None else mask
    r_part = torch.empty((b, geo["n_groups"]), dtype=torch.float32, device=m.device)
    lib = _factored_lib()
    with torch.cuda.device(m.device):
        err = lib.repro_subspace_apply_factored(
            m.data_ptr(), y.data_ptr(), f.data_ptr(), vr.data_ptr(), rho.data_ptr(),
            mu.data_ptr(), thresh.data_ptr(), mvec.data_ptr(), l_out.data_ptr(),
            s_out.data_ptr(), y_out.data_ptr(), r_part.data_ptr(), rsq.data_ptr(), b, vec,
            d2, r, geo["tile_rows"], geo["n_groups"], backend.stream_ptr(m),
        )
    backend.check_launch(err, "subspace_apply_factored")
    subspace_apply_factored.launches += 1
    return l_out, s_out, y_out, rsq


#: Kernel launches since the count was last set to 0 (plain version excluded).
subspace_apply_factored.launches = 0
