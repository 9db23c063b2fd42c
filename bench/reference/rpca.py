"""Plain FedRPCA aggregation with a cross-round session, in float64.

The semantics the configuration states, written out again from the paper
(Algorithm 2, Candes et al.'s inexact-ALM PCP) without any code of the
program:

    mu = vec * n / (4 ||M||_1),  lam = 1 / sqrt(max(vec, n)),  rho = 1 / mu
    L <- SVT_rho(M - S + rho Y)
    S <- shrink_{rho lam}(M - L + rho Y)
    Y <- Y + mu (M - L - S)

for a fixed number of iterations, over one (vec, n_clients) matrix per LoRA
factor (A and B of each targeted projection of each layer).  The update is
``mean(L) + beta mean(S)`` with the adaptive ``beta = clip(1 / E, 1, 100)``,
``E = ||S 1|| / ||M 1||``.

The SVT is the configured subspace mode: a basis of width r tracked by power
sweeps, CholeskyQR and Rayleigh-Ritz, with an exact eigendecomposition of
the thin-side Gram matrix on a cold start, when the previous live count
filled the width, or when the Ritz residual passes the tolerance.  These
routing decisions, and the warm-start gate of the session, are taken over
all modules of one bucket together (modules whose vector lengths round to
the same canonical size), so the reference groups its modules the same way.
A session carries L, S, Y, the basis and the live counts from one round to
the next; a round starts from them when every module's initial relative
residual ``||M - L - S|| / ||M||`` is within the gate.

``dtype`` is float64 for the reference; the control runs the same code in
float32 with TF32 matrix products (see ``tf32``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch

EPS = 1e-12
#: Canonical bucket vector lengths; above the last, multiples of it.
CANONICAL = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def canonical(vec: int) -> int:
    for c in CANONICAL:
        if vec <= c:
            return c
    return -(-vec // CANONICAL[-1]) * CANONICAL[-1]


def subspace_width(n_clients: int, rank: int) -> int:
    return max(1, min(rank, (n_clients + 1) // 2)) if n_clients > 1 else 1


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matrix products on a card while active (the control's precision)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def shrink(x, t):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _sym_eigh(a):
    return torch.linalg.eigh((a + a.mT) * 0.5)


def _coef(s, t):
    ss = shrink(s, t)
    return torch.where(s > EPS, ss / torch.clamp_min(s, EPS), torch.zeros_like(s)), ss


@dataclass
class AggSettings:
    iters: int = 50
    rank: int = 8
    sweeps: int = 2
    tol: float = 1e-3
    gate: float = 1.0
    beta_min: float = 1.0
    beta_max: float = 100.0


@dataclass
class BucketState:
    l: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    v: torch.Tensor
    n_live: torch.Tensor
    n_eff: float


@dataclass
class Session:
    """The reference's carry: one ``BucketState`` per bucket."""

    settings: AggSettings
    dtype: torch.dtype = torch.float64
    buckets: dict = field(default_factory=dict)
    fallbacks: int = 0  # exact steps of the last round, summed over buckets


def _exact(g, t, r):
    w, vf = _sym_eigh(g)
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    coef, ss = _coef(s, t[:, None])
    p = (vf * coef[:, None, :]) @ vf.mT
    n_live = (ss > 0).sum(-1)
    return p, vf[:, :, -r:], n_live


def _orth(z):
    """CholeskyQR with a trace-scaled jitter: Z R^-1, R^T R = Z^T Z + j I."""
    zz = z.mT @ z
    r = zz.shape[-1]
    tr = torch.diagonal(zz, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(r, dtype=z.dtype, device=z.device)
    chol = torch.linalg.cholesky(zz + ((1e-6 / r) * (tr + EPS))[:, None, None] * eye)
    return torch.linalg.solve_triangular(chol.mT, z, upper=True, left=False)


def _svt_step(g, t, v, n_live, rel, cold, st: AggSettings):
    """(P, v, n_live, rel, fell_back) of one subspace SVT over a bucket."""
    r = v.shape[-1]
    if cold or bool(torch.any(n_live >= r)):
        p, v2, nl = _exact(g, t, r)
        return p, v2, nl, torch.full_like(rel, 0.5 * st.tol), True
    n = st.sweeps
    if st.sweeps > 1 and bool(torch.max(rel) <= 0.1 * st.tol):
        n = 1
    for _ in range(max(n, 1)):
        v = _orth(g @ v)
    gv = g @ v
    theta, rot = _sym_eigh(v.mT @ gv)
    vr, gvr = v @ rot, gv @ rot
    s = torch.sqrt(torch.clamp_min(theta, 0.0))
    coef, ss = _coef(s, t[:, None])
    p = (vr * coef[:, None, :]) @ vr.mT
    live = (ss > 0).to(g.dtype)
    res = (gvr - vr * theta[:, None, :]) * live[:, None, :]
    mass = torch.clamp_min(torch.clamp_min(theta, 0.0).sum(-1), EPS)
    rel2 = torch.sqrt((res * res).sum((1, 2))) / mass
    nl = live.sum(-1).to(torch.int64)
    if bool(torch.any(rel2 > st.tol) | torch.any(nl >= r)):
        p, v2, nl = _exact(g, t, r)
        return p, v2, nl, torch.full_like(rel, 0.5 * st.tol), True
    return p, vr, nl, rel2, False


def rpca_bucket(m, dims, state: BucketState | None, st: AggSettings):
    """ADMM over a (B, vec, n) bucket; ``dims`` are the true vector lengths.
    Returns (L, S, new state, exact steps)."""
    b, _, n = m.shape
    dims = dims.to(m.dtype)
    numel = dims * n
    a1 = torch.abs(m).sum((1, 2))
    mu = torch.where(a1 > EPS, numel / (4.0 * torch.clamp_min(a1, EPS)), torch.ones_like(a1))
    lam = 1.0 / torch.sqrt(torch.clamp_min(dims, float(n)))
    rho = 1.0 / mu
    th = rho * lam
    m_norm = torch.clamp_min(torch.sqrt((m * m).sum((1, 2))), EPS)
    r3, mu3, th3 = rho[:, None, None], mu[:, None, None], th[:, None, None]
    r = subspace_width(n, st.rank)
    warm = False
    if state is not None and state.n_eff == float(n):
        res0 = m - state.l - state.s
        warm = bool(torch.all(torch.sqrt((res0 * res0).sum((1, 2))) / m_norm <= st.gate))
    if warm:
        l, s, y = state.l, state.s, state.y
        v, n_live = state.v, state.n_live
        rel = torch.full((b,), 0.5 * st.tol, dtype=m.dtype, device=m.device)
    else:
        l = s = y = torch.zeros_like(m)
        v = torch.eye(n, r, dtype=m.dtype, device=m.device).expand(b, n, r)
        n_live = torch.full((b,), r, dtype=torch.int64, device=m.device)
        rel = torch.full((b,), math.inf, dtype=m.dtype, device=m.device)
    x = m - s + r3 * y
    g = x.mT @ x
    falls = 0
    for it in range(st.iters):
        p, v, n_live, rel, fell = _svt_step(g, rho, v, n_live, rel, it == 0 and not warm, st)
        falls += int(fell)
        l = (m - s + r3 * y) @ p
        s = shrink(m - l + r3 * y, th3)
        y = y + mu3 * (m - l - s)
        x = m - s + r3 * y
        g = x.mT @ x
    return l, s, BucketState(l, s, y, v, n_live, float(n)), falls


def aggregate(session: Session, mats: list, device=None):
    """One round: ``mats`` is a list of (vec, n_clients) client-delta
    matrices, one a module.  Returns the list of (vec,) updates and updates
    ``session`` in place."""
    st, dt = session.settings, session.dtype
    groups: dict = {}
    for i, mt in enumerate(mats):
        groups.setdefault(canonical(mt.shape[0]), []).append(i)
    out = [None] * len(mats)
    session.fallbacks = 0
    for key, idx in sorted(groups.items()):
        n = mats[idx[0]].shape[1]
        m = torch.zeros((len(idx), key, n), dtype=dt, device=device or mats[idx[0]].device)
        for j, i in enumerate(idx):
            m[j, : mats[i].shape[0]] = mats[i].to(m.device, dt)
        dims = torch.tensor([mats[i].shape[0] for i in idx], device=m.device)
        l, s, state, falls = rpca_bucket(m, dims, session.buckets.get(key), st)
        session.buckets[key] = state
        session.fallbacks += falls
        msum = torch.linalg.vector_norm(m.sum(-1), dim=-1)
        energy = torch.linalg.vector_norm(s.sum(-1), dim=-1) / torch.clamp_min(msum, EPS)
        beta = torch.clamp(1.0 / torch.clamp_min(energy, EPS), st.beta_min, st.beta_max)
        upd = l.mean(-1) + beta[:, None] * s.mean(-1)
        for j, i in enumerate(idx):
            out[i] = upd[j, : mats[i].shape[0]]
    return out
