"""Fused base + LoRA projection: the CUDA kernels and their wrappers.

Replaces the Pallas TPU kernels ``src/repro/kernels/lora_matmul.py::
lora_matmul`` (one adapter) and ``::gathered_lora_matmul`` (a pool of
adapters, one slot per row):

    y[m] = x[m] @ W + scale * (x[m] @ A[s_m]) @ B[s_m]

Both wrappers launch the same kernels of ``csrc/lora_matmul.cu``: a pass
that takes x @ A at the real rank reading x once, then the base product
x @ W with the correction in its epilogue.  At prefill (M > 64, bf16) the
base product is a persistent ``wgmma`` GEMM of 128 x 256 (or 128 x 128)
tiles launched as the pass's programmatic dependent; at decode it splits K
across blocks, as does the fp32 FMA route when the output has too few
tiles to fill the card.  ``plan`` mirrors the geometry of a call,
``geometry`` reads the built kernels'.

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

While tracing (``utils.trace``), ``repro.lora.forward`` spans a forward (the
kernel, or the plain version) and ``repro.lora.backward`` a backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, ref
from repro_torch.utils import trace

_C = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: Widest adapter rank the kernel takes.
MAX_RANK = 64
_TYPES = (torch.float32, torch.bfloat16)

#: The H100's SMs (the rules that pick a geometry count them) and the
#: shared memory a block may take there.
SMS = 132
SMEM_LIMIT = 232448
#: The prefill GEMM (``lora_gemm_wide``): two consumer warpgroups and a
#: producer warpgroup, 128-row tiles, 16 row tiles a raster group, a 192 KB
#: ring (x 128 x 64 and W 64 x BN bf16 a stage: 4 stages at 256-wide tiles,
#: 6 at 128-wide ones); its shared memory is 1024 bytes of slack to align
#: the ring to the swizzle atom, the ring, the epilogue's B rows (2
#: warpgroups x 8 ranks x 256 columns, fp32 at most) and a full and an empty
#: barrier for each of up to 6 stages.
GEMM_THREADS = 384
GEMM_STAGES = {256: 4, 128: 6}
GEMM_BM = 128
GROUP_M = 16
GEMM_SMEM = 1024 + 4 * (GEMM_BM * 64 * 2 + 64 * 256 * 2) + 2 * 8 * 256 * 4 + 2 * 6 * 8
#: Registers a thread of the prefill GEMM after setmaxnreg.
CONSUMER_REGS, PRODUCER_REGS = 232, 40
#: The decode GEMM (``lora_gemm_tc``): 64 x 128 tiles, one consumer
#: warpgroup and a producer warp; the scalar route's 128 x 128 tiles.
DECODE_TILE, DECODE_THREADS = (64, 128), 160
SCALAR_TILE, SCALAR_THREADS = (128, 128), 256
#: x @ A: warps of a block along K (each a 16-row group's run of k), and
#: the static shared bytes of its staged A / partial sums by rank width.
XA_WARPS_K = 4
XA_SMEM = {8: 34816, 64: 32768}


def _lib():
    lib = backend.load_library("lora_matmul")
    lib.repro_lora_matmul.argtypes = (
        [_C] * 8 + [_I] * 5 + [_LL, _LL, ctypes.c_float, _I, _I, _I, _C]
    )
    lib.repro_lora_matmul.restype = _I
    lib.repro_lora_scratch.argtypes = [_I] * 5 + [ctypes.POINTER(_LL)]
    lib.repro_lora_scratch.restype = _I
    lib.repro_lora_splits.argtypes = [_I] * 4
    lib.repro_lora_splits.restype = _I
    lib.repro_lora_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    lib.repro_lora_plan.restype = _I
    lib.repro_lora_geometry.argtypes = [ctypes.POINTER(_I)]
    lib.repro_lora_geometry.restype = _I
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


def _split_rule(m: int, n: int, k: int, tensor: bool) -> int:
    """``csrc/lora_matmul.cu::route_splits``: the tensor route splits only at
    decode (M <= 64); K is split where the 128 x 128 tiles leave the card
    short of two blocks an SM, never below 16 K steps of 8 a split."""
    if tensor and m > 64:
        return 1
    tiles = -(-m // 128) * -(-n // 128)
    if tiles >= 2 * SMS:
        return 1
    return max(1, min(-(-2 * SMS // tiles), max(1, -(-k // 8) // 16)))


def _xa_rule(m: int, k: int, gemm_split: bool) -> tuple[int, int, int]:
    """``csrc/lora_matmul.cu::xa_geom``: (16-row groups a block, k a warp,
    planes along K).  One plane unless the GEMM splits K; then up to 16
    blocks share K, 4 warps each."""
    steps = -(-k // 32)
    if not gemm_split:
        return (2 if m > 64 else 1), 32 * -(-steps // XA_WARPS_K), 1
    most = min(16, -(-k // 128))
    kw = 32 * -(-steps // (XA_WARPS_K * most))
    return 1, kw, -(-k // (XA_WARPS_K * kw))


def wide_bn(m: int, n: int, k: int) -> int:
    """The prefill tile's width (``csrc/lora_matmul.cu::wide_bn``): 256
    where 256-wide tiles fill a round of the 132 SMs, take no more rounds
    than 128-wide ones (in rounds of 128 columns) and K >= 2048; else 128."""
    tm = -(-m // GEMM_BM)
    t256, t128 = tm * -(-n // 256), tm * -(-n // 128)
    if t256 < SMS or k < 2048:
        return 128
    return 128 if -(-t128 // SMS) < 2 * -(-t256 // SMS) else 256


def plan(m: int, n: int, k: int, dtype: torch.dtype = torch.bfloat16,
         aligned: bool = True, clusters: int = SMS // 2) -> dict:
    """The geometry of an (M, K) @ (K, N) call, as ``csrc/lora_matmul.cu``
    launches it: the base product's ``route`` and ``kernel``, its K
    ``splits`` (a ``lora_finish`` pass adds them when more than one), its
    ``tile`` (rows, columns), ``grid`` and ``threads``; on the prefill
    tensor route also the ring's ``stages``, ``smem_bytes``, the persistent
    grid of ``clusters`` of two CTAs (at most the card's, ``clusters`` = 66
    on an H100 whose every SM can pair; one block an SM), each cluster
    walking ``pairs`` of row tiles of the ``tiles`` (row tiles, column
    tiles) in the grouped raster (``group_m`` row tiles a group;
    ``gemm_tiles`` lists a block's walk), the ``rounds`` of pairs over the
    clusters and the last one's ``last_round_fill``; whether the GEMM is
    launched as the x @ A pass's programmatic ``dependent``; and the x @ A
    pass's ``xa_rows`` a block, ``xa_threads``, ``xa_kw`` (k a warp takes,
    4 warps along K a block), ``xa_planes`` (blocks along K, added in order
    by their reader) and ``xa_grid`` (blocks along M, planes)."""
    name = route(k, n, dtype, aligned=aligned)
    tensor = name == "tensor"
    splits = _split_rule(m, n, k, tensor)
    groups, kw, planes = _xa_rule(m, k, splits > 1)
    rows = 16 * groups
    out = dict(route=name, splits=splits, dependent=False, xa_rows=rows,
               xa_threads=32 * XA_WARPS_K * groups, xa_kw=kw, xa_planes=planes,
               xa_grid=(-(-m // rows), planes))
    if tensor and m > 64:
        bn = wide_bn(m, n, k)
        tiles = (-(-m // GEMM_BM), -(-n // bn))
        pairs = -(-tiles[0] // 2) * tiles[1]
        used = min(pairs, clusters)
        last = pairs - (-(-pairs // clusters) - 1) * clusters
        out.update(kernel="lora_gemm_wide", tile=(GEMM_BM, bn), grid=(2 * used,),
                   clusters=used, threads=GEMM_THREADS, stages=GEMM_STAGES[bn],
                   smem_bytes=GEMM_SMEM, tiles=tiles, pairs=pairs, group_m=GROUP_M,
                   rounds=pairs / clusters, last_round_fill=last / clusters, dependent=True)
    else:
        tile, threads = (DECODE_TILE, DECODE_THREADS) if tensor else (SCALAR_TILE,
                                                                      SCALAR_THREADS)
        out.update(kernel="lora_gemm_tc" if tensor else "lora_gemm", tile=tile, threads=threads,
                   grid=(-(-n // tile[1]), -(-m // tile[0]), splits))
    return out


def gemm_tiles(p: dict, block: int) -> list[tuple[int, int]]:
    """The (row tile, column tile) pairs that block ``block`` of a prefill
    plan ``p`` computes, in order: rank ``block % 2`` of cluster ``block //
    2``, which walks the tile pairs cluster + i * clusters of the grouped
    raster (``csrc/lora_matmul.cu::pair_at``); a pair's second row tile
    past M (an odd number of row tiles) is computed as zeros and not
    stored, so it is left out."""
    tiles_m, tiles_n = p["tiles"]
    pair_rows, group = -(-tiles_m // 2), GROUP_M // 2
    per_group = group * tiles_n
    rank, cluster = block % 2, block // 2
    walk = []
    for t in range(cluster, pair_rows * tiles_n, p["clusters"]):
        grp, r = divmod(t, per_group)
        rows = min(pair_rows - grp * group, group)
        tm = 2 * (grp * group + r % rows) + rank
        if tm < tiles_m:
            walk.append((tm, r // rows))
    return walk


def launched_plan(m: int, n: int, k: int, route_name: str) -> dict:
    """What the built library launches for the call on the current card
    (``repro_lora_plan``): the numbers ``plan`` predicts, for the card's
    check of the plan."""
    out = (_I * 12)()
    backend.check_launch(_lib().repro_lora_plan(m, n, k, int(route_name == "tensor"), out),
                         "lora_matmul plan")
    keys = ("splits", "tile_m", "tile_n", "grid_x", "grid_y", "grid_z", "xa_rows", "xa_threads",
            "xa_kw", "xa_planes", "xa_blocks", "max_clusters")
    return dict(zip(keys, out))


def geometry() -> dict:
    """The built kernels' geometry, as the CUDA library reports it (the fp32
    pool's instances, the serving pool's type): the prefill GEMM's
    ``threads``, ``smem_bytes``, ``registers`` a thread at launch (the
    256-wide tile; ``registers_n128``) and after setmaxnreg
    (``consumer_registers``, ``producer_registers``), ``blocks_per_sm`` (the
    occupancy calculator's) and ring ``stages`` (256-wide); the x @ A pass's
    ``xa_threads`` at prefill, ``xa_smem_bytes`` (static), ``xa_registers``
    and ``xa_blocks_per_sm`` (rank 8, bf16 x); the bytes a thread spills
    (``local_bytes``: both GEMM widths together; ``xa_local_bytes``); and
    the GEMM's ``clusters`` of two that fit the card at once."""
    out = (_I * 15)()
    backend.check_launch(_lib().repro_lora_geometry(out), "lora_matmul geometry")
    keys = ("threads", "smem_bytes", "registers", "registers_n128", "consumer_registers",
            "producer_registers", "blocks_per_sm", "stages", "xa_threads", "xa_smem_bytes",
            "xa_registers", "xa_blocks_per_sm", "local_bytes", "xa_local_bytes", "clusters")
    return dict(zip(keys, out))


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
    floats = (_LL * 2)()  # the x @ A planes, the split-K partial sums
    backend.check_launch(lib.repro_lora_scratch(m, n, k, r, int(tensor), floats), name)
    xa = torch.empty((floats[0],), dtype=torch.float32, device=x.device)
    partial = (torch.empty((floats[1],), dtype=torch.float32, device=x.device)
               if floats[1] else None)
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


@trace.traced("repro.lora.forward")
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
        with trace.span("repro.lora.backward"):
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
