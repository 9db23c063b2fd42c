"""Robust PCA via ADMM / Principal Component Pursuit (the paper's Algorithm 2).

Port of ``repro/core/rpca.py``.  The inexact-ALM PCP of Candès et al. (2011)

    minimize  ||L||_* + lam * ||S||_1   s.t.  M = L + S

with the paper's defaults ``mu = numel(M) / (4 ||M||_1)``,
``lam = 1 / sqrt(max(d1, d2))``, ``rho = 1 / mu``, and iterates

    L <- SVT_rho(M - S + rho * Y)
    S <- shrink_{rho*lam}(M - L + rho * Y)
    Y <- Y + mu * (M - L - S)

The SVT uses the Gram trick (``eigh`` of the thin-side Gram matrix) or, in
subspace mode, warm-started subspace iteration with an exact-eigh fallback.
``robust_pca_bucket`` runs the whole loop over a (B, vec, n_clients) bucket;
on a CUDA bucket its elementwise tail always runs the hand-written kernels
(``kernels/rpca_admm.py::admm_tail`` in gram mode,
``kernels/svt_subspace.py::subspace_apply`` in subspace mode), on a CPU
bucket the inline tensor tail.  The eigh, Cholesky, triangular solve and the SVT's
small products stay ``torch.linalg`` / ``torch.matmul``.

The JAX loops are ``fori_loop`` / ``while_loop`` / ``lax.cond``; here they are
Python loops and ``if``s, so the subspace routing and the tolerance loop read
a scalar from the device once per ADMM iteration.  Cross-round carries
(``carry=`` / ``return_carry=``, a ``BucketCarry``) warm-start a call from the
previous round's fixed point; their gate is computed on the device and read
on the host once a call.  Every such read goes through ``trace.host_read``
(``sync.svt_route``, ``svt_sweeps``, ``svt_accept``, ``admm_tol``,
``warm_gate``), and a card's ``eigh`` counts its own read of its info
(``sync.eigh``).  While tracing, ``repro.rpca.admm`` spans a bucket loop,
``repro.rpca.svt_exact`` / ``svt_ritz`` its SVTs and ``repro.rpca.apply`` its
tails; ``rpca.exact.cold`` / ``saturated`` / ``rejected`` count why each
exact step ran.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import backend
from repro_torch.launch.mesh import client_shard_count
from repro_torch.utils import trace

_EPS = 1e-12

#: Valid ``svt_mode`` values.
SVT_MODES = ("gram", "subspace")

def soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    """Elementwise shrinkage ``sign(x) * max(|x| - t, 0)``."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _eigh(a: torch.Tensor):
    """Ascending eigh of the symmetrized input, as ``jnp.linalg.eigh``
    (whose ``symmetrize_input`` default takes (a + a^T) / 2 first).  On a
    card the call reads its info on the host once."""
    trace.sync("eigh", a.device)
    return torch.linalg.eigh((a + a.mT) * 0.5)


def _shrink_coef(s: torch.Tensor, s_shrunk: torch.Tensor) -> torch.Tensor:
    return torch.where(s > _EPS, s_shrunk / torch.clamp_min(s, _EPS), torch.zeros_like(s))


def svt_gram(x: torch.Tensor, t, shrink_fn: Callable = soft_threshold) -> torch.Tensor:
    """Singular-value thresholding via the Gram matrix of the thin side."""
    d1, d2 = x.shape
    transpose = d1 < d2
    if transpose:
        x = x.T
    w, v = _eigh(x.T @ x)
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    coef = _shrink_coef(s, shrink_fn(s, t))
    low = (x @ (v * coef[None, :])) @ v.T
    return low.T if transpose else low


def svt_svd(x: torch.Tensor, t, shrink_fn: Callable = soft_threshold) -> torch.Tensor:
    """Reference SVT via the thin SVD."""
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    return (u * shrink_fn(s, t)[None, :]) @ vh


def svt_gram_batched(
    x: torch.Tensor, t: torch.Tensor, shrink_fn: Callable = soft_threshold
) -> torch.Tensor:
    """Batched Gram-trick SVT: ``x`` is (B, d1, d2), ``t`` per module (B,).
    The transpose decision is shared by the bucket; padded zero rows stay
    exactly zero."""
    d1, d2 = x.shape[1:]
    transpose = d1 < d2
    if transpose:
        x = x.mT
    w, v = _eigh(x.mT @ x)
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    coef = _shrink_coef(s, shrink_fn(s, t[:, None]))
    low = (x @ (v * coef[:, None, :])) @ v.mT
    return low.mT if transpose else low


# ---------------------------------------------------------------------------
# Sparse-energy client anomaly scores
# ---------------------------------------------------------------------------


def client_sparse_energy(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per-client column energy ratio ``||S[:, c]|| / ||M[:, c]||`` over
    (..., vec, clients) inputs."""
    num = torch.linalg.vector_norm(s, dim=-2)
    den = torch.linalg.vector_norm(m, dim=-2)
    return num / torch.clamp_min(den, _EPS)


def energy_guard_weights(energy, k: float, base_w=None, valid=None):
    """Zero the weights of clients whose sparse-energy score exceeds ``k``
    times the median over valid clients of the same module, and renormalize
    per module.  Returns (weights, float32 flags)."""
    if valid is None:
        vals = energy
    else:
        vals = torch.where(valid > 0, energy, torch.full_like(energy, float("nan")))
    # jnp.nanmedian averages the two middle values of an even count.
    med = torch.nanquantile(vals, 0.5, dim=-1, keepdim=True)
    flagged = energy > k * torch.clamp_min(med, _EPS)
    if valid is not None:
        flagged = flagged & (valid > 0)
    if base_w is None:
        w = torch.ones_like(energy)
    else:
        w = torch.broadcast_to(base_w.to(torch.float32), energy.shape)
    if valid is not None:
        w = w * valid
    w = torch.where(flagged, torch.zeros_like(w), w)
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), _EPS)
    return w, flagged.to(torch.float32)


# ---------------------------------------------------------------------------
# Warm-started subspace-iteration SVT
# ---------------------------------------------------------------------------


class SubspaceState(NamedTuple):
    """Warm-start state threaded through the ADMM loop: ``v`` (B, d2, r)
    orthonormal basis, ``g`` (B, d2, d2) Gram of the current iterate,
    ``n_live`` (B,) int32 post-shrink live directions, ``rel`` (B,) last
    live-direction subspace residual."""

    v: torch.Tensor
    g: torch.Tensor
    n_live: torch.Tensor
    rel: torch.Tensor


class SVTSubspaceResult(NamedTuple):
    low_rank: torch.Tensor
    v: torch.Tensor
    n_live: torch.Tensor
    rel: torch.Tensor
    fell_back: bool  # True when the exact eigh path ran


def subspace_rank(d2: int, rank: int, true_cols: int | None = None) -> int:
    """Carried subspace width: the cap ``rank``, but at most ceil(c/2) of
    the c live cohort columns (``true_cols`` when the bucket is padded)."""
    c = d2 if true_cols is None else max(1, min(int(true_cols), d2))
    return max(1, min(rank, (c + 1) // 2)) if c > 1 else 1


def subspace_init(m: torch.Tensor, rank: int, true_cols: int | None = None) -> SubspaceState:
    """Cold-start state for a (B, d1, d2) bucket: identity-column basis and
    the Gram of X_0 = M."""
    b, _, d2 = m.shape
    r = subspace_rank(d2, rank, true_cols)
    v = torch.eye(d2, r, dtype=torch.float32, device=m.device).expand(b, d2, r)
    return SubspaceState(
        v=v,
        g=m.mT @ m,
        n_live=torch.full((b,), r, dtype=torch.int32, device=m.device),
        rel=torch.full((b,), math.inf, dtype=torch.float32, device=m.device),
    )


@trace.traced("repro.rpca.svt_exact")
def _exact_projector(g, t, r, shrink_fn):
    """Full-eigh fallback: the exact SVT projector with all d2 directions,
    plus the top-r eigenbasis (top directions last) to reseed the state."""
    w, v_full = _eigh(g)
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    s_shrunk = shrink_fn(s, t[:, None])
    coef = _shrink_coef(s, s_shrunk)
    p = (v_full * coef[:, None, :]) @ v_full.mT
    v_top = v_full[:, :, -r:]
    n_live = torch.sum((s_shrunk > 0.0).to(torch.int32), dim=-1, dtype=torch.int32)
    rel = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    return p, v_top, n_live, rel


def _jittered_cholesky(szz: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the (B, r, r) Gram ``szz`` plus the
    reference's trace-scaled jitter.  A Cholesky that fails gives NaN, as
    JAX's does (``cholesky_ex`` instead of raising)."""
    r = szz.shape[-1]
    trace = torch.diagonal(szz, dim1=-2, dim2=-1).sum(-1)
    jitter = (1e-6 / r) * (trace + _EPS)[:, None, None]
    eye = torch.eye(r, dtype=szz.dtype, device=szz.device)
    chol, info = torch.linalg.cholesky_ex(szz + jitter * eye)
    return torch.where((info > 0)[:, None, None], torch.full_like(chol, float("nan")), chol)


def _solve_chol_t(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """V with V @ chol^T = Z, as lax.linalg.triangular_solve(left_side=False,
    lower=True, transpose_a=True)."""
    return torch.linalg.solve_triangular(chol.mT, z, upper=True, left=False)


def _orthonormalize(z: torch.Tensor) -> torch.Tensor:
    """Batched CholeskyQR: Q with span(Q) = span(Z), Q = Z R^-1 where
    Z^T Z = R^T R."""
    return _solve_chol_t(_jittered_cholesky(z.mT @ z), z)


@trace.traced("repro.rpca.svt_ritz")
def _ritz_projector(g, t, v, n_sweeps, shrink_fn):
    """``n_sweeps`` power sweeps (G V + CholeskyQR), then Rayleigh-Ritz on
    the r x r projection with the shrink applied to the Ritz values.
    Returns (P, Ritz basis, live count, live-direction subspace residual)."""
    for _ in range(n_sweeps):
        v = _orthonormalize(g @ v)
    gv = g @ v
    theta, w_rot = _eigh(v.mT @ gv)
    both = torch.cat([v, gv], dim=1) @ w_rot
    d2 = v.shape[1]
    vr, gvr = both[:, :d2], both[:, d2:]
    s = torch.sqrt(torch.clamp_min(theta, 0.0))
    s_shrunk = shrink_fn(s, t[:, None])
    coef = _shrink_coef(s, s_shrunk)
    p = (vr * coef[:, None, :]) @ vr.mT
    live = (s_shrunk > 0.0).to(torch.float32)
    res = (gvr - vr * theta[:, None, :]) * live[:, None, :]
    g_mass = torch.sum(torch.clamp_min(theta, 0.0), dim=-1)
    rel = torch.sqrt(torch.sum(res * res, dim=(1, 2))) / torch.clamp_min(g_mass, _EPS)
    n_live = torch.sum(live.to(torch.int32), dim=-1, dtype=torch.int32)
    return p, vr, n_live, rel


def svt_subspace_step(
    t: torch.Tensor,
    state: SubspaceState,
    *,
    cold,
    sweeps: int = 2,
    fallback_tol: float = 1e-3,
    shrink_fn: Callable = soft_threshold,
) -> tuple[torch.Tensor, SubspaceState, bool]:
    """One warm-started SVT on the Gram state: (P, new state, fell_back).

    Same routing as the reference's nested ``lax.cond``s, as Python ``if``s:
    the exact eigh runs on the cold start, on pre-routed saturation (the
    previous live count filled the width r), or after a Ritz attempt whose
    residual exceeded ``fallback_tol`` or whose live count saturated
    (counted as ``rpca.exact.cold``, ``saturated``, ``rejected``).  The
    attempt takes one sweep when every previous residual was within a tenth
    of the tolerance, else ``sweeps``.
    """
    r = state.v.shape[-1]
    g = state.g

    def exact(why):
        trace.count("rpca.exact." + why)
        return (*_exact_projector(g, t, r, shrink_fn), True)

    def attempt():
        n = max(sweeps, 1)
        if sweeps > 1 and trace.host_read(torch.max(state.rel) <= 0.1 * fallback_tol,
                                          "svt_sweeps"):
            n = 1
        p, v2, live, rel = _ritz_projector(g, t, state.v, n, shrink_fn)
        if trace.host_read(torch.any(rel > fallback_tol) | torch.any(live >= r), "svt_accept"):
            return exact("rejected")
        return p, v2, live, rel, False

    if bool(cold):
        p, v2, live2, rel2, fell = exact("cold")
    elif trace.host_read(torch.any(state.n_live >= r), "svt_route"):
        p, v2, live2, rel2, fell = exact("saturated")
    else:
        p, v2, live2, rel2, fell = attempt()
    if fell:
        # An exact step leaves no residual signal; report half the
        # tolerance so the next attempt runs real tracking sweeps.
        rel2 = torch.full_like(rel2, 0.5 * fallback_tol)
    return p, SubspaceState(v=v2, g=g, n_live=live2, rel=rel2), fell


def svt_subspace(
    x: torch.Tensor,
    t,
    v: torch.Tensor | None = None,
    *,
    rank: int = 8,
    sweeps: int = 2,
    fallback_tol: float = 1e-3,
    shrink_fn: Callable = soft_threshold,
) -> SVTSubspaceResult:
    """Single-matrix warm-started subspace SVT; ``v=None`` is a cold start."""
    if x.ndim != 2:
        raise ValueError(f"svt_subspace expects a 2-D matrix, got {tuple(x.shape)}")
    d2 = x.shape[1]
    r = subspace_rank(d2, rank)
    xb = x[None].to(torch.float32)
    cold = v is None
    vb = (
        torch.eye(d2, r, dtype=torch.float32, device=x.device)[None]
        if cold
        else v[None].to(torch.float32)
    )
    state = SubspaceState(
        v=vb,
        g=xb.mT @ xb,
        n_live=torch.zeros((1,), dtype=torch.int32, device=x.device),
        rel=torch.full((1,), 0.5 * fallback_tol, dtype=torch.float32, device=x.device),
    )
    tb = trace.to_device(t, "rpca_constants", x.device, torch.float32).reshape(1)
    p, state, fell = svt_subspace_step(
        tb, state, cold=cold, sweeps=sweeps, fallback_tol=fallback_tol, shrink_fn=shrink_fn,
    )
    low = (xb @ p)[0].to(x.dtype)
    return SVTSubspaceResult(
        low_rank=low, v=state.v[0], n_live=state.n_live[0], rel=state.rel[0], fell_back=fell,
    )


# ---------------------------------------------------------------------------
# Per-matrix RPCA
# ---------------------------------------------------------------------------


class RPCAResult(NamedTuple):
    low_rank: torch.Tensor
    sparse: torch.Tensor
    n_iter: torch.Tensor
    residual: torch.Tensor  # ||M - L - S||_F / ||M||_F at exit
    # Whole-bucket exact-eigh SVT steps taken (subspace mode; 0 in gram
    # mode) — the count the reference reports as ``BucketCarry.fall_count``.
    n_fallback: int = 0


class BucketCarry(NamedTuple):
    """Cross-round warm-start state of one bucket's RPCA.

    The exit iterates ``l``, ``s`` and the dual ``y`` (float32, bucket
    layout (B, padded_vec, d2)), the subspace basis ``v`` (B, d2, r) with
    its live ranks ``n_live``, and the gate's scalars: a warm start is taken
    only when ``valid`` is set, the cohort fingerprint ``n_eff`` matches and
    every module's initial relative residual ``||M - l - s|| / ||M||`` is at
    most ``carry_gate`` (a cold start scores exactly 1.0).  ``fall_count``
    and ``hit`` describe the call that produced the carry: its exact-eigh
    steps and whether it warm-started."""

    l: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    v: torch.Tensor
    n_live: torch.Tensor
    n_eff: torch.Tensor  # () float32 cohort fingerprint at save time
    valid: torch.Tensor  # () bool: the carry holds real state
    fall_count: torch.Tensor  # () int32 exact-eigh steps of the producing call
    hit: torch.Tensor  # () float32: 1.0 iff the producing call warm-started


def init_bucket_carry(
    n_modules: int, padded_vec: int, d2: int, svt_rank: int,
    true_cols: int | None = None, device="cuda",
) -> BucketCarry:
    """Empty (invalid) carry with the shapes of one bucket on ``device``
    (``"cuda"`` unless the caller asks for the CPU).  ``true_cols`` must be
    the value the consuming call passes, or the basis widths disagree."""
    dev = backend.resolve_device(device)
    r = subspace_rank(d2, svt_rank, true_cols)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return BucketCarry(
        l=z(n_modules, padded_vec, d2), s=z(n_modules, padded_vec, d2),
        y=z(n_modules, padded_vec, d2), v=z(n_modules, d2, r),
        n_live=torch.zeros((n_modules,), dtype=torch.int32, device=dev),
        n_eff=z(), valid=torch.zeros((), dtype=torch.bool, device=dev),
        fall_count=torch.zeros((), dtype=torch.int32, device=dev), hit=z(),
    )


def _check_carry(carry, shape, basis_shape=None) -> None:
    if tuple(carry.l.shape) != tuple(shape):
        raise ValueError(f"carry shape {tuple(carry.l.shape)} does not match bucket {tuple(shape)}")
    if basis_shape is not None and tuple(carry.v.shape) != tuple(basis_shape):
        raise ValueError(
            f"carry basis shape {tuple(carry.v.shape)} != {tuple(basis_shape)}; "
            "was the carry built with a different svt_rank?"
        )


def _warm_gate(carry, init_sq, m_norm, n_eff, carry_gate) -> bool:
    """The warm-start gate over the whole bucket, computed on ``m_norm``'s
    device and read on the host once: valid, the same n_eff fingerprint, and
    every module's initial relative residual (from its squared norm
    ``init_sq``) within ``carry_gate``."""
    dev = m_norm.device
    init_err = torch.sqrt(init_sq) / m_norm
    warm = (carry.valid.to(dev) & (carry.n_eff.to(dev) == n_eff)
            & torch.all(init_err <= carry_gate))
    return trace.host_read(warm, "warm_gate")


def _new_carry(l, s, y, v, n_live, n_eff, falls: int, warm: bool) -> BucketCarry:
    dev = l.device
    return BucketCarry(
        l=l, s=s, y=y, v=v.contiguous(), n_live=n_live.to(torch.int32),
        n_eff=trace.to_device(n_eff, "carry_scalars", dev, torch.float32).reshape(()),
        valid=torch.ones((), dtype=torch.bool, device=dev),
        fall_count=trace.to_device(falls, "carry_scalars", dev, torch.int32),
        hit=trace.to_device(float(warm), "carry_scalars", dev, torch.float32),
    )


def _routes_to_bucket(m, svt_fn, svt_mode, carry, return_carry) -> bool:
    """Validate a per-matrix call; True when it runs the B=1 bucket loop
    (subspace mode, or any carry), False for the per-matrix gram loop."""
    if m.ndim != 2:
        raise ValueError(f"robust_pca expects a 2-D matrix, got shape {tuple(m.shape)}")
    if svt_mode == "gram" and carry is None and not return_carry:
        return False
    if svt_fn is not svt_gram:
        raise ValueError(
            "custom svt_fn is only honored on the carry-less "
            "svt_mode='gram' path; the bucket loop owns its SVT"
        )
    return True


def _matrix_constants(m, mu, lam):
    d1, d2 = m.shape
    abs_sum = torch.sum(torch.abs(m))
    mu_v = torch.where(
        abs_sum > _EPS, (d1 * d2) / (4.0 * torch.clamp_min(abs_sum, _EPS)),
        torch.ones_like(abs_sum),
    )
    if mu is not None:
        mu_v = trace.to_device(mu, "rpca_constants", m.device, torch.float32)
    if lam is None:
        lam_v = 1.0 / torch.sqrt(trace.to_device(float(max(d1, d2)), "rpca_constants", m.device))
    else:
        lam_v = trace.to_device(lam, "rpca_constants", m.device, torch.float32)
    return mu_v, lam_v, 1.0 / mu_v


def _matrix_bucket(m, *, n_iter, tol, mu, lam, shrink_fn, svt_mode, svt_rank,
                   svt_sweeps, svt_fallback_tol, carry, return_carry, carry_gate):
    """Per-matrix RPCA through the B=1 bucket loop on the plain tail; a
    B=1 ``BucketCarry`` threads through it in either SVT mode."""
    res = _bucket_admm(
        m[None], None, n_iter=n_iter, tol=tol, mu=mu, lam=lam, shrink_fn=shrink_fn,
        use_kernel=False, client_mask=None, svt_mode=svt_mode, svt_rank=svt_rank,
        svt_sweeps=svt_sweeps, svt_fallback_tol=svt_fallback_tol, true_cols=None,
        carry=carry, return_carry=return_carry, carry_gate=carry_gate,
    )
    res, new_carry = res if return_carry else (res, None)
    out = RPCAResult(res.low_rank[0], res.sparse[0], res.n_iter[0], res.residual[0],
                     res.n_fallback)
    return (out, new_carry) if return_carry else out


def robust_pca(
    m: torch.Tensor,
    *,
    mu=None,
    lam=None,
    tol: float = 1e-7,
    max_iter: int = 200,
    svt_fn: Callable = svt_gram,
    shrink_fn: Callable = soft_threshold,
    svt_mode: str = "gram",
    svt_rank: int = 8,
    svt_sweeps: int = 2,
    svt_fallback_tol: float = 1e-3,
    carry=None,
    return_carry: bool = False,
    carry_gate: float = 1.0,
) -> RPCAResult:
    """Decompose a 2-D ``m`` into low-rank + sparse, iterating until the
    relative residual passes ``tol`` or ``max_iter`` runs out.  Subspace
    mode and any carry route through the B=1 bucket loop (plain tail, as the
    reference does with ``fused_tail=False``); ``return_carry=True`` returns
    ``(result, BucketCarry)``."""
    if _routes_to_bucket(m, svt_fn, svt_mode, carry, return_carry):
        return _matrix_bucket(
            m, n_iter=max_iter, tol=tol, mu=mu, lam=lam, shrink_fn=shrink_fn,
            svt_mode=svt_mode, svt_rank=svt_rank, svt_sweeps=svt_sweeps,
            svt_fallback_tol=svt_fallback_tol, carry=carry, return_carry=return_carry,
            carry_gate=carry_gate,
        )
    orig_dtype = m.dtype
    m = m.to(torch.float32)
    mu_v, lam_v, rho = _matrix_constants(m, mu, lam)
    m_norm = torch.clamp_min(torch.linalg.vector_norm(m), _EPS)
    l = s = y = torch.zeros_like(m)
    err = trace.to_device(math.inf, "rpca_constants", m.device)
    i = 0
    while i < max_iter and trace.host_read(err > tol, "admm_tol"):
        l = svt_fn(m - s + rho * y, rho, shrink_fn)
        s = shrink_fn(m - l + rho * y, rho * lam_v)
        resid = m - l - s
        y = y + mu_v * resid
        err = torch.linalg.vector_norm(resid) / m_norm
        i += 1
    n_iter = trace.to_device(i, "rpca_constants", m.device, torch.int32)
    return RPCAResult(l.to(orig_dtype), s.to(orig_dtype), n_iter, err)


def robust_pca_fixed_iters(
    m: torch.Tensor,
    *,
    n_iter: int = 50,
    mu=None,
    lam=None,
    svt_fn: Callable = svt_gram,
    shrink_fn: Callable = soft_threshold,
    svt_mode: str = "gram",
    svt_rank: int = 8,
    svt_sweeps: int = 2,
    svt_fallback_tol: float = 1e-3,
    carry=None,
    return_carry: bool = False,
    carry_gate: float = 1.0,
) -> RPCAResult:
    """Fixed-iteration RPCA of a 2-D ``m`` (deterministic cost); carries
    as in ``robust_pca``."""
    if _routes_to_bucket(m, svt_fn, svt_mode, carry, return_carry):
        return _matrix_bucket(
            m, n_iter=n_iter, tol=None, mu=mu, lam=lam, shrink_fn=shrink_fn,
            svt_mode=svt_mode, svt_rank=svt_rank, svt_sweeps=svt_sweeps,
            svt_fallback_tol=svt_fallback_tol, carry=carry, return_carry=return_carry,
            carry_gate=carry_gate,
        )
    orig_dtype = m.dtype
    m = m.to(torch.float32)
    mu_v, lam_v, rho = _matrix_constants(m, mu, lam)
    m_norm = torch.clamp_min(torch.linalg.vector_norm(m), _EPS)
    l = s = y = torch.zeros_like(m)
    for _ in range(n_iter):
        l = svt_fn(m - s + rho * y, rho, shrink_fn)
        s = shrink_fn(m - l + rho * y, rho * lam_v)
        y = y + mu_v * (m - l - s)
    err = torch.linalg.vector_norm(m - l - s) / m_norm
    n_done = trace.to_device(n_iter, "rpca_constants", m.device, torch.int32)
    return RPCAResult(l.to(orig_dtype), s.to(orig_dtype), n_done, err)


def batched_robust_pca(ms: torch.Tensor, **kwargs) -> RPCAResult:
    """``robust_pca_fixed_iters`` over a leading batch axis, one matrix at a
    time (the reference vmaps it); ``ms`` is (batch, d1, d2)."""
    results = [robust_pca_fixed_iters(mi, **kwargs) for mi in ms]
    return RPCAResult(
        torch.stack([r.low_rank for r in results]),
        torch.stack([r.sparse for r in results]),
        torch.stack([r.n_iter for r in results]),
        torch.stack([r.residual for r in results]),
        sum(r.n_fallback for r in results),
    )


# ---------------------------------------------------------------------------
# One-call bucket RPCA (the batched aggregation engine's hot loop)
# ---------------------------------------------------------------------------


def robust_pca_bucket(
    m: torch.Tensor,
    true_dims: torch.Tensor | None = None,
    *,
    n_iter: int = 50,
    tol: float | None = None,
    mu: float | None = None,
    lam: float | None = None,
    shrink_fn: Callable = soft_threshold,
    fused_tail: bool = False,
    client_mask: torch.Tensor | None = None,
    svt_mode: str = "gram",
    svt_rank: int = 8,
    svt_sweeps: int = 2,
    svt_fallback_tol: float = 1e-3,
    carry=None,
    return_carry: bool = False,
    carry_gate: float = 1.0,
    true_cols: int | None = None,
) -> RPCAResult:
    """RPCA over a whole (B, vec_dim, n_clients) shape bucket.

    ``true_dims`` holds each module's unpadded vec dim, so the ADMM
    constants match the per-matrix call; padded rows stay exactly zero.
    ``client_mask`` (n_clients,) zeroes inactive columns on entry, switches
    the constants to ``n_eff = sum(mask)`` and re-masks S/Y every iteration;
    L is masked once at the end.  ``tol=None`` runs ``n_iter`` iterations;
    with a tolerance the loop runs until every module passes, freezing
    converged modules by select (``n_iter`` of the result counts each
    module's iterations).

    The device alone chooses the elementwise tail: a CUDA bucket always
    runs the hand-written kernels (``admm_tail`` in gram mode,
    ``subspace_apply`` in subspace mode), a CPU bucket the inline tensor
    tail.  ``fused_tail`` is inert; it is kept so calls read like the
    reference's.  The kernels hardcode soft-threshold shrinkage, so a
    custom ``shrink_fn`` on a CUDA bucket raises.

    ``svt_mode="subspace"`` runs the warm-started subspace SVT; ``true_cols``
    caps its width by the live cohort count when the bucket is padded.

    ``carry`` (a ``BucketCarry``) warm-starts L, S, Y and, in subspace mode,
    the basis, so iteration 0 takes the Ritz attempt; the carried iterates
    are re-masked by ``client_mask`` on load.  The gate (valid, equal
    n_eff, every initial relative residual within ``carry_gate``) is read on
    the host once a call; a rejected carry runs the carry-less program, bit
    for bit.  ``return_carry=True`` returns ``(result, BucketCarry)``.
    """
    if m.ndim != 3:
        raise ValueError(f"robust_pca_bucket expects (B, d1, d2), got {tuple(m.shape)}")
    if svt_mode not in SVT_MODES:
        raise ValueError(f"unknown svt_mode: {svt_mode!r} (expected one of {SVT_MODES})")
    return _bucket_admm(
        m, true_dims, n_iter=n_iter, tol=tol, mu=mu, lam=lam, shrink_fn=shrink_fn,
        use_kernel=backend.use_kernel(m), client_mask=client_mask, svt_mode=svt_mode,
        svt_rank=svt_rank, svt_sweeps=svt_sweeps, svt_fallback_tol=svt_fallback_tol,
        true_cols=true_cols, carry=carry, return_carry=return_carry, carry_gate=carry_gate,
    )


@trace.traced("repro.rpca.admm")
def _bucket_admm(
    m, true_dims, *, n_iter, tol, mu, lam, shrink_fn, use_kernel, client_mask,
    svt_mode, svt_rank, svt_sweeps, svt_fallback_tol, true_cols,
    carry=None, return_carry=False, carry_gate=1.0,
):
    orig_dtype = m.dtype
    dev = m.device
    m = m.to(torch.float32).contiguous()
    b, d1p, d2 = m.shape
    if true_dims is None:
        true_dims = torch.full((b,), d1p, dtype=torch.int32)
    dims_f = true_dims.to(device=dev, dtype=torch.float32)

    if client_mask is not None:
        cmask = client_mask.to(device=dev, dtype=torch.float32).contiguous()
        m = m * cmask
        n_eff = torch.clamp_min(torch.sum(cmask), 1.0)
    else:
        cmask = None
        n_eff = float(d2)

    abs_sum = torch.sum(torch.abs(m), dim=(1, 2))
    numel = dims_f * n_eff
    mu_v = torch.where(
        abs_sum > _EPS, numel / (4.0 * torch.clamp_min(abs_sum, _EPS)), torch.ones_like(abs_sum)
    )
    if mu is not None:
        mu_v = torch.full((b,), mu, dtype=torch.float32, device=dev)
    if lam is not None:
        lam_v = torch.full((b,), lam, dtype=torch.float32, device=dev)
    else:
        lam_v = 1.0 / torch.sqrt(torch.clamp_min(dims_f, n_eff))
    rho = 1.0 / mu_v
    thresh = rho * lam_v
    m_norm = torch.clamp_min(torch.sqrt(torch.sum(m * m, dim=(1, 2))), _EPS)
    rho3, mu3, th3 = rho[:, None, None], mu_v[:, None, None], thresh[:, None, None]
    use_subspace = svt_mode == "subspace"
    r = subspace_rank(d2, svt_rank, true_cols)

    warm = False
    if carry is not None:
        _check_carry(carry, m.shape, (b, d2, r) if use_subspace else None)
        cl, cs, cy = (t.to(device=dev, dtype=torch.float32) for t in (carry.l, carry.s, carry.y))
        if cmask is not None:
            # A carry saved under another active set may hold nonzeros in
            # columns masked now: re-mask on load so padded slots stay inert.
            cl, cs, cy = cl * cmask, cs * cmask, cy * cmask
        init_res = m - cl - cs
        warm = _warm_gate(carry, torch.sum(init_res * init_res, dim=(1, 2)), m_norm,
                          trace.to_device(n_eff, "n_eff", dev, torch.float32), carry_gate)

    if use_kernel:
        if shrink_fn is not soft_threshold:
            raise ValueError(
                "the fused tail kernels hardcode soft-threshold shrinkage; a "
                "custom shrink_fn needs a CPU bucket"
            )
        from repro_torch.kernels import rpca_admm, svt_subspace

        def tail(l, y):
            s, y_new, rsq = rpca_admm.admm_tail(
                m, l.contiguous(), y, rho, mu_v, thresh, mask=cmask
            )
            return s, y_new, torch.sqrt(rsq)

    elif cmask is not None:

        def tail(l, y):
            s = shrink_fn(m - l + rho3 * y, th3) * cmask
            resid = (m - l - s) * cmask
            y_new = (y + mu3 * resid) * cmask
            return s, y_new, torch.sqrt(torch.sum(resid * resid, dim=(1, 2)))

    else:

        def tail(l, y):
            s = shrink_fn(m - l + rho3 * y, th3)
            resid = m - l - s
            y_new = y + mu3 * resid
            return s, y_new, torch.sqrt(torch.sum(resid * resid, dim=(1, 2)))

    if use_subspace:

        def step(l, s, y, sub, it):
            # A warm start is never cold: the carried basis tracks the
            # carried iterates, so iteration 0 already takes the Ritz attempt.
            p, sub, fell = svt_subspace_step(
                rho, sub, cold=it == 0 and not warm, sweeps=svt_sweeps,
                fallback_tol=svt_fallback_tol, shrink_fn=shrink_fn,
            )
            with trace.span("repro.rpca.apply"):
                if use_kernel:
                    l, s2, y2, rsq, g2 = svt_subspace.subspace_apply(
                        m, s, y, p.contiguous(), rho, mu_v, thresh, mask=cmask
                    )
                    rnorm = torch.sqrt(rsq)
                else:
                    l = (m - s + rho3 * y) @ p
                    s2, y2, rnorm = tail(l, y)
                    x2 = m - s2 + rho3 * y2
                    g2 = x2.mT @ x2
            return l, s2, y2, rnorm / m_norm, sub._replace(g=g2), fell

        if warm:
            # The Gram of the initial iterate X0 = M - S0 + rho Y0, and the
            # carried basis and live ranks with half the fallback tolerance.
            x0 = m - cs + rho3 * cy
            sub = SubspaceState(
                v=carry.v.to(device=dev, dtype=torch.float32).contiguous(),
                g=x0.mT @ x0,
                n_live=carry.n_live.to(device=dev, dtype=torch.int32),
                rel=torch.full((b,), 0.5 * svt_fallback_tol, dtype=torch.float32, device=dev),
            )
        else:
            sub = SubspaceState(
                v=torch.eye(d2, r, dtype=torch.float32, device=dev).expand(b, d2, r),
                g=m.mT @ m,
                n_live=torch.full((b,), r, dtype=torch.int32, device=dev),
                rel=torch.full((b,), math.inf, dtype=torch.float32, device=dev),
            )
    else:

        def step(l, s, y, sub, it):
            with trace.span("repro.rpca.svt_exact"):
                l = svt_gram_batched(m - s + rho3 * y, rho, shrink_fn)
            with trace.span("repro.rpca.apply"):
                s, y, rnorm = tail(l, y)
            return l, s, y, rnorm / m_norm, sub, False

        sub = None

    if warm:
        l, s, y = cl, cs, cy
    else:
        zeros = torch.zeros_like(m)
        l, s, y = zeros, zeros, zeros
    err = torch.full((b,), math.inf, dtype=torch.float32, device=dev)
    falls = 0
    if tol is None:
        for it in range(n_iter):
            l, s, y, err, sub, fell = step(l, s, y, sub, it)
            falls += int(fell)
        n_done = torch.full((b,), n_iter, dtype=torch.int32, device=dev)
    else:
        n_done = torch.zeros((b,), dtype=torch.int32, device=dev)
        i = 0
        while i < n_iter and trace.host_read(torch.any(err > tol), "admm_tol"):
            l2, s2, y2, err2, sub2, fell = step(l, s, y, sub, i)
            # Freeze converged modules by select, as vmap(while_loop) does.
            active = err > tol
            a3 = active[:, None, None]
            l, s, y = torch.where(a3, l2, l), torch.where(a3, s2, s), torch.where(a3, y2, y)
            err = torch.where(active, err2, err)
            if sub is not None:
                sub = SubspaceState(
                    v=torch.where(a3, sub2.v, sub.v),
                    g=torch.where(a3, sub2.g, sub.g),
                    n_live=torch.where(active, sub2.n_live, sub.n_live),
                    rel=torch.where(active, sub2.rel, sub.rel),
                )
            i += 1
            n_done = torch.where(active, torch.full_like(n_done, i), n_done)
            falls += int(fell)

    if cmask is not None:
        l = l * cmask
    result = RPCAResult(l.to(orig_dtype), s.to(orig_dtype), n_done, err, falls)
    if not return_carry:
        return result
    if use_subspace:
        v_out, nl_out = sub.v, sub.n_live
    elif carry is not None:
        # Gram mode tracks no basis: the incoming one passes through.
        v_out, nl_out = carry.v.to(dev), carry.n_live.to(dev)
    else:
        v_out = torch.zeros((b, d2, r), dtype=torch.float32, device=dev)
        nl_out = torch.zeros((b,), dtype=torch.int32, device=dev)
    return result, _new_carry(l, s, y, v_out, nl_out, n_eff, falls, warm)


# ---------------------------------------------------------------------------
# Mesh-sharded bucket RPCA
# ---------------------------------------------------------------------------
#
# The packed client axis (d2) of a bucket is the axis that scales: cohorts
# grow, vec dims do not.  The sharded loop cuts the client COLUMNS into equal
# shards, one per device of a ``launch.mesh.ClientMesh``, and keeps each
# shard's columns of M, L, S, Y on its device.  Everything elementwise
# (shrink, dual ascent, masking) is column-local.  The subspace SVT
# decomposes around the projected factor W = X V:
#
#   W      = psum_k(X_k V_k)                one (B, d1, r) sum per sweep
#   (GV)_k = X_k^T W                        shard-local rows of G V
#   CholeskyQR, Rayleigh-Ritz               r x r psums, solved once
#   L_k    = F Vr_k^T, F = (W W_rot) coef   shard-local columns of L
#
# so the d2 x d2 Gram is never formed on the Ritz path.  Only the exact
# fallback (the cold start, a residual breach, a saturated rank) gathers X
# to eigh the full Gram once and hands each shard its rows of the basis.
# Values every shard shares (the scalars, the r x r algebra, the gates) are
# computed once on the first shard's device; every gate reads such a value,
# so all shards take the same branch, and each gate is one host read per
# iteration.  On a CUDA mesh each shard's tail is a kernel: Ritz iterations
# run ``svt_subspace.subspace_apply_factored``, exact iterations
# ``rpca_admm.admm_tail``; on a CPU mesh the same contraction runs as plain
# tensor code.

#: Mesh axis names the reference shards the packed client axis over; a
#: ``ClientMesh`` is one such axis.
CLIENT_AXIS_NAMES = ("pod", "data")

#: Bucket-axis chunks of ``mesh_overlap=True``, as in the reference.
_MESH_OVERLAP_CHUNKS = 4


def mesh_client_shards(mesh) -> int:
    """Client shards of ``mesh``; 1 (``None`` or a one-shard mesh) means
    'take the single-device path'."""
    return client_shard_count(mesh)


def robust_pca_bucket_sharded(
    m: torch.Tensor,
    true_dims: torch.Tensor | None = None,
    *,
    mesh,
    n_iter: int = 50,
    tol: float | None = None,
    mu: float | None = None,
    lam: float | None = None,
    shrink_fn: Callable = soft_threshold,
    fused_tail: bool = False,
    client_mask: torch.Tensor | None = None,
    svt_mode: str = "gram",
    svt_rank: int = 8,
    svt_sweeps: int = 2,
    svt_fallback_tol: float = 1e-3,
    carry=None,
    return_carry: bool = False,
    carry_gate: float = 1.0,
    mesh_overlap: bool = False,
    true_cols: int | None = None,
) -> RPCAResult:
    """``robust_pca_bucket`` with the client axis sharded across ``mesh``
    (a ``launch.mesh.ClientMesh``).

    Same contract as the unsharded loop, fp32-allclose to it.  One client
    shard (``None`` or a one-shard mesh) delegates to ``robust_pca_bucket``
    and gives its bits.  A ragged cohort (d2 not a multiple of the shard
    count) is zero-padded with zero-mask columns, which add exactly zero to
    every sum, and sliced back on exit.  ``n_fallback`` counts the exact
    iterations of subspace mode, the cold one included.

    A ``carry`` is split by client columns (L, S, Y) and basis rows (v),
    padded with the ragged columns, gated on psum'd sums read once on the
    first shard's device, and reassembled on exit, as in the unsharded loop.

    ``mesh_overlap=True`` cuts every psum and every tail-kernel call into
    B chunks, as the reference's overlap schedule does.  No value changes:
    psums are elementwise and a kernel's per-module results do not depend
    on the other modules of its launch.  ``fused_tail`` is inert (the
    mesh's device picks the tail); a custom ``shrink_fn`` on a CUDA mesh
    raises.  The results come back on ``m``'s device.
    """
    if mesh_client_shards(mesh) == 1:
        return robust_pca_bucket(
            m, true_dims, n_iter=n_iter, tol=tol, mu=mu, lam=lam, shrink_fn=shrink_fn,
            fused_tail=fused_tail, client_mask=client_mask, svt_mode=svt_mode,
            svt_rank=svt_rank, svt_sweeps=svt_sweeps, svt_fallback_tol=svt_fallback_tol,
            carry=carry, return_carry=return_carry, carry_gate=carry_gate,
            true_cols=true_cols,
        )
    if m.ndim != 3:
        raise ValueError(f"robust_pca_bucket expects (B, d1, d2), got {tuple(m.shape)}")
    if svt_mode not in SVT_MODES:
        raise ValueError(f"unknown svt_mode: {svt_mode!r} (expected one of {SVT_MODES})")
    return _sharded_admm(
        m, true_dims, mesh=mesh, n_iter=n_iter, tol=tol, mu=mu, lam=lam,
        shrink_fn=shrink_fn, client_mask=client_mask, svt_mode=svt_mode,
        svt_rank=svt_rank, svt_sweeps=svt_sweeps, svt_fallback_tol=svt_fallback_tol,
        mesh_overlap=mesh_overlap, true_cols=true_cols, carry=carry,
        return_carry=return_carry, carry_gate=carry_gate,
    )


@trace.traced("repro.rpca.admm")
def _sharded_admm(
    m, true_dims, *, mesh, n_iter, tol, mu, lam, shrink_fn, client_mask, svt_mode,
    svt_rank, svt_sweeps, svt_fallback_tol, mesh_overlap, true_cols,
    carry=None, return_carry=False, carry_gate=1.0,
):
    devs = mesh.devices
    d0 = devs[0]
    n_sh = len(devs)
    psum, rep = mesh.psum, mesh.replicate
    orig_dtype, out_dev = m.dtype, m.device
    m = m.to(torch.float32)
    b, d1p, d2 = m.shape
    # The rank cap keeps the true d2; padding columns only fill the shards.
    r = subspace_rank(d2, svt_rank, true_cols)
    if carry is not None:
        _check_carry(carry, m.shape, (b, d2, r))
    if true_dims is None:
        true_dims = torch.full((b,), d1p, dtype=torch.int32)
    dims_f = true_dims.to(device=d0, dtype=torch.float32)
    cmask = (torch.ones((d2,), dtype=torch.float32, device=m.device) if client_mask is None
             else client_mask.to(device=m.device, dtype=torch.float32))
    d2p = n_sh * -(-d2 // n_sh)
    if d2p != d2:
        m = torch.nn.functional.pad(m, (0, d2p - d2))
        cmask = torch.nn.functional.pad(cmask, (0, d2p - d2))
        if carry is not None:
            padc = lambda t: torch.nn.functional.pad(t.to(m.device, torch.float32), (0, d2p - d2))
            carry = carry._replace(
                l=padc(carry.l), s=padc(carry.s), y=padc(carry.y),
                v=torch.nn.functional.pad(carry.v.to(m.device, torch.float32),
                                          (0, 0, 0, d2p - d2)),
            )
    d2_loc = d2p // n_sh
    cols = [slice(k * d2_loc, (k + 1) * d2_loc) for k in range(n_sh)]
    cm = [cmask[c].to(dev).contiguous() for c, dev in zip(cols, devs)]
    mk = [(m[:, :, c].to(dev) * ck).contiguous() for c, dev, ck in zip(cols, devs, cm)]
    use_kernel = backend.use_kernel(mk[0])

    n_eff = torch.clamp_min(psum([torch.sum(ck) for ck in cm])[0], 1.0)
    abs_sum = psum([torch.sum(torch.abs(x), dim=(1, 2)) for x in mk])[0]
    numel = dims_f * n_eff
    mu_v = torch.where(
        abs_sum > _EPS, numel / (4.0 * torch.clamp_min(abs_sum, _EPS)), torch.ones_like(abs_sum)
    )
    if mu is not None:
        mu_v = torch.full((b,), mu, dtype=torch.float32, device=d0)
    if lam is not None:
        lam_v = torch.full((b,), lam, dtype=torch.float32, device=d0)
    else:
        lam_v = 1.0 / torch.sqrt(torch.clamp_min(dims_f, n_eff))
    rho = 1.0 / mu_v
    thresh = rho * lam_v
    m_norm = torch.clamp_min(
        torch.sqrt(psum([torch.sum(x * x, dim=(1, 2)) for x in mk])[0]), _EPS
    )
    rho_k, mu_k, th_k = rep(rho), rep(mu_v), rep(thresh)
    rho3 = [x[:, None, None] for x in rho_k]
    use_subspace = svt_mode == "subspace"

    warm = False
    if carry is not None:
        part = lambda t, k: t[:, :, cols[k]].to(device=devs[k], dtype=torch.float32) * cm[k]
        cl, cs, cy = ([part(t, k) for k in range(n_sh)] for t in (carry.l, carry.s, carry.y))
        init_sq = psum([torch.sum((x - a - c) ** 2, dim=(1, 2))
                        for x, a, c in zip(mk, cl, cs)])[0]
        warm = _warm_gate(carry, init_sq, m_norm, n_eff, carry_gate)

    # B chunks of the overlap schedule: one chunk unless mesh_overlap.
    bsl = [(0, b)]
    if mesh_overlap and b > 1:
        step_b = -(-b // min(b, _MESH_OVERLAP_CHUNKS))
        bsl = [(lo, min(lo + step_b, b)) for lo in range(0, b, step_b)]

    def psum_b(parts):
        if len(bsl) == 1:
            return psum(parts)
        chunks = [psum([p[lo:hi] for p in parts]) for lo, hi in bsl]
        return [torch.cat([c[k] for c in chunks]) for k in range(n_sh)]

    def by_chunk(fn, *args):
        """``fn`` over the B chunks of its (B, ...) arguments, outputs
        concatenated along B."""
        if len(bsl) == 1:
            return fn(*args)
        outs = [fn(*(a[lo:hi] for a in args)) for lo, hi in bsl]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    if use_kernel:
        if shrink_fn is not soft_threshold:
            raise ValueError(
                "the fused tail kernels hardcode soft-threshold shrinkage; a "
                "custom shrink_fn needs a CPU mesh"
            )
        from repro_torch.kernels import rpca_admm, svt_subspace

    def plain_tail(k, l, y):
        s = shrink_fn(mk[k] - l + rho3[k] * y, th_k[k][:, None, None]) * cm[k]
        resid = (mk[k] - l - s) * cm[k]
        y_new = (y + mu_k[k][:, None, None] * resid) * cm[k]
        return s, y_new, torch.sum(resid * resid, dim=(1, 2))

    def tail_exact(l, y):
        """Shard tails after an exact SVT: (S', Y', ||resid||)."""
        outs = []
        for k in range(n_sh):
            if use_kernel:
                outs.append(by_chunk(
                    lambda *a: rpca_admm.admm_tail(*a, mask=cm[k]),
                    mk[k], l[k].contiguous(), y[k], rho_k[k], mu_k[k], th_k[k],
                ))
            else:
                outs.append(plain_tail(k, l[k], y[k]))
        s2, y2, rsq = zip(*outs)
        return list(s2), list(y2), torch.sqrt(psum_b(rsq)[0])

    def tail_ritz(f, vr, y):
        """Shard tails of a Ritz SVT, L_k = F Vr_k^T: (L, S', Y', ||resid||)."""
        outs = []
        for k in range(n_sh):
            if use_kernel:
                outs.append(by_chunk(
                    lambda *a: svt_subspace.subspace_apply_factored(*a, mask=cm[k]),
                    mk[k], y[k], f[k], vr[k], rho_k[k], mu_k[k], th_k[k],
                ))
            else:
                l = f[k] @ vr[k].mT
                outs.append((l, *plain_tail(k, l, y[k])))
        l2, s2, y2, rsq = zip(*outs)
        return list(l2), list(s2), list(y2), torch.sqrt(psum_b(rsq)[0])

    @trace.traced("repro.rpca.svt_exact")
    def exact_svt(x, t):
        """Exact SVT of the gathered X: each shard's L columns and top-r
        basis rows, the live count, a zero residual."""
        xg = mesh.all_gather(x, dim=2)
        w_eig, v_full = _eigh(xg.mT @ xg)
        s_ = torch.sqrt(torch.clamp_min(w_eig, 0.0))
        s_shrunk = shrink_fn(s_, t[:, None])
        xvc = (xg @ v_full) * _shrink_coef(s_, s_shrunk)[:, None, :]
        l, v_top = [], []
        for c, dev in zip(cols, devs):
            v_loc = v_full[:, c, :].to(dev)
            l.append(xvc.to(dev) @ v_loc.mT)
            v_top.append(v_loc[:, :, -r:])
        n_live = torch.sum((s_shrunk > 0.0).to(torch.int32), dim=-1, dtype=torch.int32)
        return l, v_top, n_live, torch.zeros((b,), dtype=torch.float32, device=d0)

    def sweep_wz(x, v):
        """W = psum(X_k V_k) and Z_k = X_k^T W."""
        w = psum_b([xk @ vk for xk, vk in zip(x, v)])
        return w, [xk.mT @ wk for xk, wk in zip(x, w)]

    @trace.traced("repro.rpca.svt_ritz")
    def ritz_factors(x, t, v, n_sweeps):
        """Power sweeps on the shards' rows, then Rayleigh-Ritz: (the shrink
        factor F per shard, Ritz basis rows, live count, live-direction
        subspace residual)."""
        for _ in range(n_sweeps):
            _, z = sweep_wz(x, v)
            chol = rep(_jittered_cholesky(psum([zk.mT @ zk for zk in z])[0]))
            v = [_solve_chol_t(ck, zk) for ck, zk in zip(chol, z)]
        w, gv = sweep_wz(x, v)
        theta, w_rot = _eigh(psum([vk.mT @ gk for vk, gk in zip(v, gv)])[0])
        w_rot_k, theta_k = rep(w_rot), rep(theta)
        vr = [vk @ wk for vk, wk in zip(v, w_rot_k)]
        gvr = [gk @ wk for gk, wk in zip(gv, w_rot_k)]
        s_ = torch.sqrt(torch.clamp_min(theta, 0.0))
        s_shrunk = shrink_fn(s_, t[:, None])
        # X Vr = W W_rot is in hand and replicated: F needs no more sums.
        f = (w[0] @ w_rot) * _shrink_coef(s_, s_shrunk)[:, None, :]
        live = (s_shrunk > 0.0).to(torch.float32)
        live_k = rep(live)
        res = [(g - v_ * th[:, None, :]) * lv[:, None, :]
               for g, v_, th, lv in zip(gvr, vr, theta_k, live_k)]
        g_mass = torch.sum(torch.clamp_min(theta, 0.0), dim=-1)
        rel = torch.sqrt(psum([torch.sum(x_ * x_, dim=(1, 2)) for x_ in res])[0])
        rel = rel / torch.clamp_min(g_mass, _EPS)
        n_live = torch.sum(live.to(torch.int32), dim=-1, dtype=torch.int32)
        return rep(f.contiguous()), [x_.contiguous() for x_ in vr], n_live, rel

    def svt_step(x, v, n_live, rel_prev, cold):
        """The reference's gates as Python ``if``s on replicated values:
        (("exact", L) or ("ritz", F, Vr), basis, live, residual, fell)."""

        def exact(why):
            trace.count("rpca.exact." + why)
            l, v2, live, rel = exact_svt(x, rho)
            return ("exact", l), v2, live, rel, True

        def attempt():
            n = max(svt_sweeps, 1)
            if svt_sweeps > 1 and trace.host_read(
                    torch.max(rel_prev) <= 0.1 * svt_fallback_tol, "svt_sweeps"):
                n = 1
            f, vr, live, rel = ritz_factors(x, rho, v, n)
            if trace.host_read(torch.any(rel > svt_fallback_tol) | torch.any(live >= r),
                               "svt_accept"):
                return exact("rejected")
            return ("ritz", f, vr), vr, live, rel, False

        if cold:
            svt, v2, live2, rel2, fell = exact("cold")
        elif trace.host_read(torch.any(n_live >= r), "svt_route"):
            svt, v2, live2, rel2, fell = exact("saturated")
        else:
            svt, v2, live2, rel2, fell = attempt()
        if fell:
            rel2 = torch.full_like(rel2, 0.5 * svt_fallback_tol)
        return svt, v2, live2, rel2, fell

    def step(l, s, y, sub, it):
        x = [a - b_ + r3 * c for a, b_, r3, c in zip(mk, s, rho3, y)]
        if not use_subspace:
            l, *_ = exact_svt(x, rho)
            with trace.span("repro.rpca.apply"):
                s2, y2, rnorm = tail_exact(l, y)
            return l, s2, y2, rnorm / m_norm, sub, False
        v, n_live, rel = sub
        svt, v2, live2, rel2, fell = svt_step(x, v, n_live, rel, cold=it == 0 and not warm)
        with trace.span("repro.rpca.apply"):
            if svt[0] == "exact":
                l = svt[1]
                s2, y2, rnorm = tail_exact(l, y)
            else:
                l, s2, y2, rnorm = tail_ritz(svt[1], svt[2], y)
        return l, s2, y2, rnorm / m_norm, (v2, live2, rel2), fell

    sub = None
    if use_subspace and warm:
        sub = (
            [carry.v[:, c, :].to(device=dev, dtype=torch.float32).contiguous()
             for c, dev in zip(cols, devs)],
            carry.n_live.to(device=d0, dtype=torch.int32),
            torch.full((b,), 0.5 * svt_fallback_tol, dtype=torch.float32, device=d0),
        )
    elif use_subspace:
        eye = torch.eye(d2p, r, dtype=torch.float32)
        sub = (
            [trace.to_device(eye[c], "basis_init", dev).expand(b, d2_loc, r)
             for c, dev in zip(cols, devs)],
            torch.full((b,), r, dtype=torch.int32, device=d0),
            torch.full((b,), math.inf, dtype=torch.float32, device=d0),
        )
    if warm:
        l, s, y = cl, cs, cy
    else:
        l, s, y = ([torch.zeros_like(x) for x in mk] for _ in range(3))
    err = torch.full((b,), math.inf, dtype=torch.float32, device=d0)
    falls = 0
    if tol is None:
        for it in range(n_iter):
            l, s, y, err, sub, fell = step(l, s, y, sub, it)
            falls += int(fell)
        n_done = torch.full((b,), n_iter, dtype=torch.int32, device=d0)
    else:
        n_done = torch.zeros((b,), dtype=torch.int32, device=d0)
        i = 0
        while i < n_iter and trace.host_read(torch.any(err > tol), "admm_tol"):
            l2, s2, y2, err2, sub2, fell = step(l, s, y, sub, i)
            # Freeze converged modules by select, on every shard.
            active = err > tol
            a3 = [a[:, None, None] for a in rep(active)]
            sel = lambda new, old: [torch.where(a, n_, o) for a, n_, o in zip(a3, new, old)]
            l, s, y = sel(l2, l), sel(s2, s), sel(y2, y)
            err = torch.where(active, err2, err)
            if sub is not None:
                sub = (
                    sel(sub2[0], sub[0]),
                    torch.where(active, sub2[1], sub[1]),
                    torch.where(active, sub2[2], sub[2]),
                )
            i += 1
            n_done = torch.where(active, torch.full_like(n_done, i), n_done)
            falls += int(fell)

    def gather(parts, dim=2):
        """The shards' parts joined along ``dim``, the ragged padding sliced
        off, on ``m``'s device in float32."""
        full = mesh.all_gather(parts, dim=dim)
        return full.narrow(dim, 0, d2).to(out_dev)

    l = [lk * ck for lk, ck in zip(l, cm)]
    l_full = gather(l)
    result = RPCAResult(
        l_full.to(orig_dtype), gather(s).to(orig_dtype), n_done.to(out_dev),
        err.to(out_dev), falls,
    )
    if not return_carry:
        return result
    if use_subspace:
        v_out, nl_out = gather(sub[0], dim=1), sub[1]
    elif carry is not None:
        v_out, nl_out = carry.v[:, :d2], carry.n_live
    else:
        v_out = torch.zeros((b, d2, r), dtype=torch.float32)
        nl_out = torch.zeros((b,), dtype=torch.int32)
    return result, _new_carry(l_full, gather(s), gather(y), v_out.to(out_dev),
                              nl_out.to(out_dev), n_eff.to(out_dev), falls, warm)
