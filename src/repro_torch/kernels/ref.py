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


def svt_subspace_apply_factored_ref(m, y, f, vr, rho, mu, thresh, mask=None):
    """Factored-projector SVT tail of one client shard (twin of
    ``ref.svt_subspace_apply_factored_ref``): L = F Vr^T in fp32 from the
    (B, vec, r) shrink factor and the (B, clients, r) basis rows, then the
    ADMM tail; the residual sum is this shard's partial.  L is left
    unmasked."""
    rho_, mu_, th_ = _scalars(m, rho, mu, thresh)
    msk = _mask(m, mask)
    low = torch.matmul(f.to(torch.float32), vr.to(torch.float32).mT).to(m.dtype)
    s_new = soft_threshold_ref(m - low + rho_ * y, th_) * msk
    resid = (m - low - s_new) * msk
    y_new = (y + mu_ * resid) * msk
    rsq = torch.sum(torch.square(resid.to(torch.float32)), dim=(1, 2))
    return low, s_new, y_new, rsq


def lora_matmul_ref(x, w, a, b, scale: float = 1.0) -> torch.Tensor:
    """y = x @ w + scale * (x @ a) @ b (twin of ``ref.lora_matmul_ref``),
    rounded where the kernel rounds: every operand is taken in x's dtype
    (as ``layers.dense`` casts the adapter), both products accumulate in
    fp32, x @ a is rounded to x's dtype before the second product, and the
    sum is rounded once.  In float32 the roundings are exact."""
    xf = x.float()
    xa = (xf @ a.to(x.dtype).float()).to(x.dtype).float()
    acc = xf @ w.to(x.dtype).float() + scale * (xa @ b.to(x.dtype).float())
    return acc.to(x.dtype)


def gathered_lora_matmul_ref(x, w, a_pool, b_pool, row_slot, scale: float = 1.0) -> torch.Tensor:
    """Per-row adapter y_m = x_m @ w + scale * (x_m @ A[s_m]) @ B[s_m]
    (twin of ``ref.gathered_lora_matmul_ref``): every slot's full-batch
    LoRA product, kept on the rows that name it; slot -1 rows get the base
    projection only.  Rounded as ``lora_matmul_ref``."""
    xf = x.float()
    lora = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for s in range(a_pool.shape[0]):
        sel = (row_slot == s)[:, None]
        xa = (xf @ a_pool[s].to(x.dtype).float()).to(x.dtype).float()
        lora = torch.where(sel, xa @ b_pool[s].to(x.dtype).float(), lora)
    return (xf @ w.to(x.dtype).float() + scale * lora).to(x.dtype)


def local_attention_ref(q, k, v, *, window: int, causal: bool = True) -> torch.Tensor:
    """Sliding-window causal attention over (BH, S, D) with materialized
    fp32 scores (twin of ``ref.local_attention_ref``); masked scores are
    -1e30, not -inf, as in the reference."""
    s = q.shape[1]
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None], scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_scan_ref(x, da, b, c, chunk: int = 256, *, h0=None, return_state: bool = False):
    """Mamba-2 SSD core, y_t = sum_{j<=t} C_t . B_j exp(sum_{j<k<=t} da_k) x_j,
    by the sequential scan h_t = exp(da_t) h_{t-1} + B_t^T x_t, y_t = C_t h_t
    (twin of ``ref.ssd_scan_ref``; exact, so ``chunk`` is unused).

    x (BH, S, P), da (BH, S); b and c (G, S, N) with G dividing BH, row bh
    reading group bh // (BH // G) (G = BH: one per row).  float32 inside,
    y in x's dtype.  ``h0`` (BH, N, P) is the state before position 0
    (zero when None); with ``return_state`` also returns the final state
    (BH, N, P) in float32.
    """
    del chunk
    bh, s, p = x.shape
    rep = bh // b.shape[0]
    xf, daf = x.float(), da.float()
    bf, cf = (t.float().repeat_interleave(rep, dim=0) for t in (b, c))
    h = (torch.zeros((bh, b.shape[-1], p), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        h = torch.exp(daf[:, t])[:, None, None] * h + bf[:, t, :, None] * xf[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], h))
    y = (torch.stack(ys, dim=1) if ys else xf.new_zeros((bh, 0, p))).to(x.dtype)
    return (y, h) if return_state else y


def ssd_split_ref(x, da, b, c, *, h0=None, return_state: bool = False, tile: int = 64):
    """The same SSD core as ``ssd_scan_ref``, decomposed as the CUDA kernel
    computes it (``csrc/ssd_scan.cu``), in tiles of ``tile`` positions.  The
    half that does not read the state, for every tile at once: the raw
    scores C B^T once per group, the decayed scores L o C B^T (the upper
    triangle selected to 0, never multiplied by a mask), y_intra = (L o C
    B^T) x and the tile's own state s = (B o w)^T x, w_j = exp(cum_last -
    cum_j).  Then the serial half, tile by tile: y = exp(cum_i) C h +
    y_intra from the state entering the tile, and the carry h <-
    exp(cum_last) h + s.  Shapes, groups, dtypes and ``h0`` as
    ``ssd_scan_ref``."""
    bh, s, p = x.shape
    g, n = b.shape[0], b.shape[-1]
    rep = bh // g
    nt = max(1, -(-s // tile))
    pad = nt * tile - s
    xf, daf, bf, cf = x.float(), da.float(), b.float(), c.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        daf = torch.nn.functional.pad(daf, (0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    xt = xf.reshape(g, rep, nt, tile, p)
    cum = torch.cumsum(daf.reshape(g, rep, nt, tile), dim=-1)
    bt = bf.reshape(g, nt, tile, n)
    ct = cf.reshape(g, nt, tile, n)
    # The h-free half.
    scores = ct @ bt.mT  # (G, nt, T, T): once per group
    tril = torch.ones((tile, tile), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    y_intra = torch.where(tril, decay * scores[:, None], zero) @ xt
    w = torch.exp(cum[..., -1:] - cum)
    s_tile = (bt[:, None] * w[..., None]).mT @ xt  # (G, rep, nt, N, P)
    # The h-bound half.
    h = (torch.zeros((g, rep, n, p), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float().reshape(g, rep, n, p))
    tile_decay = torch.exp(cum[..., -1])
    ys = []
    for k in range(nt):
        inter = ct[:, None, k] @ h
        ys.append(torch.exp(cum[:, :, k])[..., None] * inter + y_intra[:, :, k])
        h = tile_decay[:, :, k, None, None] * h + s_tile[:, :, k]
    y = torch.stack(ys, dim=2).reshape(bh, nt * tile, p)[:, :s].to(x.dtype)
    return (y, h.reshape(bh, n, p)) if return_state else y


def ssd_chunked_ref(x, da, b, c, chunk: int, *, h0=None, return_state: bool = False):
    """The same SSD core as ``ssd_scan_ref`` in the chunked dual form (the
    reference's differentiable ``models/ssd.py::ssd_chunked``, in the
    kernel's layout): within a chunk of Q positions the masked quadratic
    form (L o C B^T) x, across chunks the carried state.  A few dozen
    batched ops for any S, so its autograd is the backward of the SSD
    kernel.  Shapes, groups, dtypes and ``h0`` as ``ssd_scan_ref``."""
    bh, s, p = x.shape
    g, n = b.shape[0], b.shape[-1]
    rep = bh // g
    q = max(1, min(int(chunk), s))
    pad = (-s) % q
    nc = (s + pad) // q
    xf, daf, bf, cf = x.float(), da.float(), b.float(), c.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        daf = torch.nn.functional.pad(daf, (0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    xc = xf.reshape(g, rep, nc, q, p)
    cum = torch.cumsum(daf.reshape(g, rep, nc, q), dim=-1)
    bc = bf.reshape(g, nc, q, n)
    cc = cf.reshape(g, nc, q, n)
    # Intra-chunk: lower-triangular decays exp(cum_i - cum_j), j <= i.
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tril, cum[..., :, None] - cum[..., None, :],
                      torch.full((), float("-inf"), device=x.device))
    scores = cc @ bc.mT  # (G, nc, Q, Q)
    y = (torch.exp(seg) * scores[:, None]) @ xc
    # Each chunk's contribution to the state at its end, then the carry.
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = bc[:, None].mT @ (decay_to_end[..., None] * xc)  # (G, rep, nc, N, P)
    chunk_decay = torch.exp(cum[..., -1])
    h = (torch.zeros((g, rep, n, p), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float().reshape(g, rep, n, p))
    entering = []
    for ci in range(nc):
        entering.append(h)
        h = chunk_decay[:, :, ci, None, None] * h + states[:, :, ci]
    y = y + (cc[:, None] @ torch.stack(entering, dim=2)) * torch.exp(cum)[..., None]
    y = y.reshape(bh, nc * q, p)[:, :s].to(x.dtype)
    return (y, h.reshape(bh, n, p)) if return_state else y
