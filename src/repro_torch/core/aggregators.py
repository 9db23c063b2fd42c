"""Server-side aggregation strategies for federated LoRA.

Port of ``repro/core/aggregators.py``, over stacked client-delta trees
(leading axis = clients):

  * ``fedavg``          — Eq. 4: (weighted) mean.
  * ``task_arithmetic`` — Eq. 5: scaled mean.
  * ``fedexp``          — FedExP's extrapolated mean.
  * ``ties``            — TIES-Merging (trim, elect sign, disjoint mean).
  * ``dare``            — DARE drop-and-rescale, then the mean.
  * ``fedrpca``         — Algorithm 1: per-module Robust-PCA split M = L + S,
                          update = mean(L) + beta * mean(S), adaptive
                          beta = 1 / E (App. B.3).

Two engines back ``aggregate``: the per-leaf functions here
(``engine="reference"``, the plain parity oracle — never a kernel) and the
batched engine in ``repro_torch.core.engine`` (``engine="packed"``, one call
per shape bucket, whose RPCA tail runs the CUDA kernels on the card).

DARE's keep masks come from a CPU ``torch.Generator`` seeded from (key, leaf
index[, client slot]), so the card and the CPU draw the same bits; ``key``
is an int or a sequence of nonnegative ints.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import rpca as rpca_lib
from repro_torch.core import stacking
from repro_torch.kernels import backend
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_to, tree_unflatten

Tree = Any

#: Client weighting schemes: "uniform", "data_size" (FedAvg with n_k / n),
#: "data_size_rpca" (also column-scales the RPCA input by the weights).
WEIGHTINGS = ("uniform", "data_size", "data_size_rpca")

#: Cross-round aggregation carry modes: "none" is stateless; "subspace"
#: carries each bucket's subspace-SVT session (basis and iterates) and needs
#: ``svt_mode="subspace"``; "full" carries the ADMM iterates in either mode.
#: The carry threads through the packed engine's sessions
#: (``engine.AggSession`` / ``aggregate_planned``); the reference engine
#: ignores it.
CARRY_MODES = ("none", "subspace", "full")


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Configuration shared by all aggregation strategies (field for field
    the reference's, with the same defaults).

    ``rpca_fused_tail`` is kept so configs compare field for field, and is
    inert: the device decides.  A CUDA bucket of the packed engine always
    runs the fused CUDA tail kernels, a CPU bucket the plain tail.
    """

    method: str = "fedrpca"  # fedavg | task_arithmetic | ties | fedexp | dare | fedrpca
    weighting: str = "uniform"  # uniform | data_size | data_size_rpca
    beta: float = 2.0  # scaling factor (task_arithmetic, fixed-beta fedrpca)
    adaptive_beta: bool = True  # fedrpca: beta = 1 / E^(t)
    beta_min: float = 1.0  # clip range for the adaptive beta
    beta_max: float = 100.0
    rpca_iters: int = 50  # ADMM iteration count / cap
    rpca_tol: float = 1e-7  # stopping tolerance when rpca_fixed_iters=False
    rpca_fixed_iters: bool = True  # False: tolerance-based early stopping
    rpca_fused_tail: bool = False  # inert: the device picks the tail (see above)
    mesh_overlap: bool = False  # sharded agg: B-chunk every psum and tail kernel
    svt_mode: str = "gram"  # gram (per-iteration eigh) | subspace (warm-started)
    svt_rank: int = 8  # subspace mode: carried basis width cap
    svt_sweeps: int = 2  # subspace mode: power sweeps per ADMM iteration
    svt_fallback_tol: float = 1e-3  # subspace-residual bound before eigh fallback
    carry_mode: str = "none"  # cross-round session carry (see CARRY_MODES)
    carry_gate: float = 1.0  # warm-start gate
    retier_every: int = 0  # AggSession re-tiering cadence
    retier_margin: int = 1  # live-rank headroom of the low tier
    ties_keep: float = 0.1  # TIES trim fraction
    ties_scale: float = 1.0  # TIES final scaling
    dare_drop: float = 0.9  # DARE drop rate
    joint_ab: bool = False  # RPCA jointly over concatenated vec(A), vec(B)
    guard_energy_k: float = 0.0  # sparse-energy quarantine threshold (0 = off)

    def replace(self, **kw) -> "AggregatorConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Client validity masks and weights
# ---------------------------------------------------------------------------


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _client_weights(mask=None, weights=None, device="cpu"):
    """Normalized (n_clients,) float32 weights, or None for the unweighted
    path; masked slots get weight exactly zero."""
    if mask is None and weights is None:
        return None
    if weights is None:
        w = _as_f32(mask, device)
    else:
        w = _as_f32(weights, device)
        if mask is not None:
            w = w * _as_f32(mask, device)
    return w / torch.clamp_min(torch.sum(w), 1e-12)


def _wmean_leaf(leaf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading client axis, accumulated in float32."""
    return torch.tensordot(w, leaf.to(torch.float32), dims=([0], [0])).to(leaf.dtype)


def _mask_n_eff(mask, n_clients: int, device="cpu"):
    if mask is None:
        return n_clients
    return torch.clamp_min(torch.sum(_as_f32(mask, device)), 1.0)


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


# ---------------------------------------------------------------------------
# Simple strategies
# ---------------------------------------------------------------------------


def fedavg(stacked: Tree, mask=None, weights=None) -> Tree:
    """Eq. 4: unweighted mean, or sum_k (n_k / n) d_k over active clients."""
    w = _client_weights(mask, weights, _device_of(stacked))
    if w is None:
        return tree_map(lambda x: torch.mean(x, dim=0), stacked)
    return tree_map(lambda x: _wmean_leaf(x, w), stacked)


def task_arithmetic(stacked: Tree, beta: float = 2.0, mask=None, weights=None) -> Tree:
    w = _client_weights(mask, weights, _device_of(stacked))
    if w is None:
        return tree_map(lambda x: beta * torch.mean(x, dim=0), stacked)
    return tree_map(lambda x: (beta * _wmean_leaf(x, w)).to(x.dtype), stacked)


_FEDEXP_EPS = 1e-3


def _fedexp_eta(sum_sq, mean_sq, n_eff, eps: float = _FEDEXP_EPS):
    """FedExP's global step ``max(1, sum_sq / (2 n_eff (mean_sq + eps)))``,
    shared by the per-leaf and the packed engine."""
    return torch.clamp_min(sum_sq / (2.0 * n_eff * (mean_sq + eps)), 1.0)


def fedexp(stacked: Tree, eps: float = _FEDEXP_EPS, mask=None, weights=None) -> Tree:
    """FedExP: the mean scaled by the global step
    ``max(1, sum_i ||d_i||^2 / (2 M (||mean(d)||^2 + eps)))``, with the sum
    over active clients and M = n_eff under a mask."""
    mean = fedavg(stacked, mask=mask, weights=weights)
    leaves = tree_leaves(stacked)
    dev = leaves[0].device
    bmask = None if mask is None else _as_f32(mask, dev)

    def sq_stacked(x):
        x = x.to(torch.float32)
        if bmask is not None:
            x = x * bmask.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.sum(torch.square(x))

    total = lambda parts: functools.reduce(lambda a, b: a + b, parts)
    n_eff = _mask_n_eff(mask, leaves[0].shape[0], dev)
    mean_sq = total([torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(mean)])
    sum_sq = total([sq_stacked(x) for x in leaves])
    eta = _fedexp_eta(sum_sq, mean_sq, n_eff, eps)
    return tree_map(lambda x: (eta * x).to(x.dtype), mean)


def _keyed_generator(key, *path: int) -> torch.Generator:
    """A CPU generator seeded from ``key`` (an int or ints) and the path of
    ints below it."""
    entropy = [int(v) for v in np.asarray(key, dtype=np.int64).reshape(-1)]
    seed = np.random.SeedSequence([*entropy, *path]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def _dare_keep(key, leaf_index: int, leaf_shape, drop_rate: float, mask=None) -> torch.Tensor:
    """Bernoulli(1 - drop_rate) keep mask of one stacked leaf, a CPU bool
    tensor.  Without a mask one draw covers the leaf, seeded from (key,
    leaf index); with one, client slot j draws its own pattern from (key,
    leaf index, j), so slot j keeps the same pattern whether the cohort is
    padded or dense."""
    keep_p = 1.0 - drop_rate
    if mask is None:
        gen = _keyed_generator(key, leaf_index)
        return torch.rand(tuple(leaf_shape), generator=gen) < keep_p
    return torch.stack([
        torch.rand(tuple(leaf_shape[1:]), generator=_keyed_generator(key, leaf_index, j))
        < keep_p
        for j in range(leaf_shape[0])
    ])


def _dare_leaves(stacked: Tree, drop_rate: float, key, mask=None) -> list:
    """Every leaf of ``stacked`` dropped and rescaled by 1 / (1 - p)."""
    if key is None:
        raise ValueError("dare requires an explicit PRNG key (got key=None)")
    out = []
    for i, leaf in enumerate(tree_leaves(stacked)):
        keep = _dare_keep(key, i, tuple(leaf.shape), drop_rate, mask).to(leaf.device)
        out.append(torch.where(keep, leaf, torch.zeros_like(leaf)) / (1.0 - drop_rate))
    return out


def dare(stacked: Tree, drop_rate: float = 0.9, key=None, mask=None, weights=None) -> Tree:
    """DARE: drop ``drop_rate`` of each client delta's entries at random,
    rescale the rest by 1 / (1 - p), then average.  ``key`` is required: a
    fixed stream would drop the same entries every round."""
    w = _client_weights(mask, weights, _device_of(stacked))
    out = []
    for leaf, rescaled in zip(tree_leaves(stacked), _dare_leaves(stacked, drop_rate, key, mask)):
        if w is None:
            out.append(torch.mean(rescaled, dim=0).to(leaf.dtype))
        else:
            out.append(_wmean_leaf(rescaled, w).to(leaf.dtype))
    return tree_unflatten(stacked, out)


# ---------------------------------------------------------------------------
# TIES-Merging
# ---------------------------------------------------------------------------


def _ties_elect(trimmed: torch.Tensor, client_dim: int, w=None) -> torch.Tensor:
    """Sign election and disjoint mean over ``client_dim`` of the trimmed
    values; ``w`` (normalized, broadcast along ``client_dim``) weighs both."""
    if w is None:
        elected = torch.sign(torch.sum(trimmed, dim=client_dim, keepdim=True))
        elected = torch.where(elected == 0.0, torch.ones_like(elected), elected)
        agree = (torch.sign(trimmed) == elected) & (trimmed != 0.0)
        num = torch.sum(torch.where(agree, trimmed, 0.0), dim=client_dim)
        den = torch.clamp_min(torch.sum(agree.to(torch.float32), dim=client_dim), 1.0)
    else:
        elected = torch.sign(torch.sum(w * trimmed, dim=client_dim, keepdim=True))
        elected = torch.where(elected == 0.0, torch.ones_like(elected), elected)
        agree = (torch.sign(trimmed) == elected) & (trimmed != 0.0)
        num = torch.sum(torch.where(agree, w * trimmed, 0.0), dim=client_dim)
        # A weighted count is zero only where num is zero too: 0 / eps = 0.
        den = torch.clamp_min(torch.sum(w * agree.to(torch.float32), dim=client_dim), 1e-12)
    return num / den


def _ties_leaf(leaf: torch.Tensor, keep: float, scale: float, w=None) -> torch.Tensor:
    """TIES on one stacked leaf: (clients, ...) -> (...).  Each client keeps
    its top ``max(int(keep * d), 1)`` entries by magnitude."""
    n_clients = leaf.shape[0]
    flat = leaf.reshape(n_clients, -1).to(torch.float32)
    k = max(int(keep * flat.shape[1]), 1)
    absx = torch.abs(flat)
    kth = torch.topk(absx, k, dim=1).values[:, -1:]  # per-client k-th largest
    trimmed = torch.where(absx >= kth, flat, 0.0)
    merged = scale * _ties_elect(trimmed, 0, None if w is None else w[:, None])
    return merged.reshape(leaf.shape[1:]).to(leaf.dtype)


def ties_merging(stacked: Tree, keep: float = 0.1, scale: float = 1.0, mask=None,
                 weights=None) -> Tree:
    w = _client_weights(mask, weights, _device_of(stacked))
    return tree_map(lambda x: _ties_leaf(x, keep, scale, w), stacked)


# ---------------------------------------------------------------------------
# FedRPCA (the paper)
# ---------------------------------------------------------------------------


def sparse_energy_ratio(m_mat: torch.Tensor, s_mat: torch.Tensor) -> torch.Tensor:
    """E^(t) = ||S . 1|| / ||M . 1|| (App. B.3) over (..., vec, clients)."""
    s_sum = torch.linalg.vector_norm(torch.sum(s_mat, dim=-1), dim=-1)
    m_sum = torch.linalg.vector_norm(torch.sum(m_mat, dim=-1), dim=-1)
    return s_sum / torch.clamp_min(m_sum, 1e-12)


def _fedrpca_matrix(m_mat, cfg, shrink_fn, mask=None, w=None, col_scale=None):
    """FedRPCA on one (vec_dim, n_clients) matrix; returns (update vector,
    beta, energy, residual, client energy, client flags).  The n_eff
    constants are re-stated here rather than shared with
    ``rpca.robust_pca_bucket``: this path is the packed engine's oracle."""
    mu = lam = None
    if col_scale is not None:
        m_mat = m_mat * col_scale.to(m_mat.dtype)[None, :]
    if mask is not None:
        cmask = _as_f32(mask, m_mat.device).to(m_mat.dtype)
        m_mat = m_mat * cmask
        d1 = m_mat.shape[0]
        n_eff = torch.clamp_min(torch.sum(cmask.to(torch.float32)), 1.0)
        abs_sum = torch.sum(torch.abs(m_mat))
        mu = torch.where(
            abs_sum > 1e-12, (d1 * n_eff) / (4.0 * torch.clamp_min(abs_sum, 1e-12)),
            torch.ones_like(abs_sum),
        )
        lam = 1.0 / torch.sqrt(torch.clamp_min(torch.tensor(float(d1), device=m_mat.device), n_eff))
    svt_kw = dict(
        svt_mode=cfg.svt_mode, svt_rank=cfg.svt_rank, svt_sweeps=cfg.svt_sweeps,
        svt_fallback_tol=cfg.svt_fallback_tol,
    )
    if cfg.rpca_fixed_iters:
        res = rpca_lib.robust_pca_fixed_iters(
            m_mat, n_iter=cfg.rpca_iters, mu=mu, lam=lam, shrink_fn=shrink_fn, **svt_kw,
        )
    else:
        res = rpca_lib.robust_pca(
            m_mat, tol=cfg.rpca_tol, max_iter=cfg.rpca_iters, mu=mu, lam=lam,
            shrink_fn=shrink_fn, **svt_kw,
        )
    n_clients = m_mat.shape[-1]
    client_energy = rpca_lib.client_sparse_energy(m_mat, res.sparse)
    client_flagged = torch.zeros((n_clients,), dtype=torch.float32, device=m_mat.device)
    if cfg.guard_energy_k > 0:
        valid = None if mask is None else _as_f32(mask, m_mat.device)
        w, client_flagged = rpca_lib.energy_guard_weights(
            client_energy, cfg.guard_energy_k, base_w=w, valid=valid,
        )
    if w is None:
        low_rank_mean = torch.mean(res.low_rank, dim=-1)
        sparse_mean = torch.mean(res.sparse, dim=-1)
    else:
        low_rank_mean = res.low_rank @ w
        sparse_mean = res.sparse @ w
    energy = sparse_energy_ratio(m_mat, res.sparse)
    if cfg.adaptive_beta:
        beta = torch.clamp(1.0 / torch.clamp_min(energy, 1e-12), cfg.beta_min, cfg.beta_max)
    else:
        beta = torch.tensor(cfg.beta, dtype=torch.float32, device=m_mat.device)
    update = low_rank_mean + beta * sparse_mean
    return update, beta, energy, res.residual, client_energy, client_flagged


def _fedrpca_mats(mats, cfg, shrink_fn, mask, w, col_scale):
    """``_fedrpca_matrix`` over (modules, vec, clients), one module at a
    time (the reference vmaps it); outputs stacked on the module axis."""
    outs = [
        _fedrpca_matrix(mi, cfg, shrink_fn, mask=mask, w=w, col_scale=col_scale)
        for mi in mats.to(torch.float32)
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _fedrpca_leaf(leaf, cfg, shrink_fn, mask=None, w=None, col_scale=None):
    """FedRPCA on one stacked leaf, per module (layer) of the leaf."""
    mats = stacking.leaf_matrices(leaf)
    updates, *rest = _fedrpca_mats(mats, cfg, shrink_fn, mask, w, col_scale)
    return (stacking.matrices_to_leaf_update(updates, leaf), *rest)


def _fedrpca_joint_ab(node, cfg, shrink_fn, mask=None, w=None, col_scale=None):
    """App. B.2 joint mode: RPCA over concatenated [vec(dA); vec(dB)]
    columns of one adapter pair, then split the update back."""
    mats_a = stacking.leaf_matrices(node["A"]).to(torch.float32)
    mats_b = stacking.leaf_matrices(node["B"]).to(torch.float32)
    va = mats_a.shape[1]
    joint = torch.cat([mats_a, mats_b], dim=1)
    updates, *rest = _fedrpca_mats(joint, cfg, shrink_fn, mask, w, col_scale)
    upd_a = stacking.matrices_to_leaf_update(updates[:, :va], node["A"])
    upd_b = stacking.matrices_to_leaf_update(updates[:, va:], node["B"])
    return ({"A": upd_a, "B": upd_b}, *rest)


def _is_ab_node(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"A", "B"}


def fedrpca(
    stacked: Tree,
    cfg: Optional[AggregatorConfig] = None,
    shrink_fn: Callable = rpca_lib.soft_threshold,
    with_diagnostics: bool = False,
    mask=None,
    weights=None,
):
    """Algorithm 1 server update over a stacked client-delta tree.

    Diagnostics carry the per-leaf scalar keys (``leaf{i}/beta_mean``, or
    ``pair{i}/...`` under ``joint_ab``) and flat per-module ``"beta"``,
    ``"energy"`` and ``"residual"`` arrays, so ``rpca_diag_summary`` reads
    either engine's output."""
    cfg = cfg or AggregatorConfig()
    dev = _device_of(stacked)
    w = _client_weights(mask, weights, dev)
    col_scale = None
    if cfg.weighting == "data_size_rpca" and w is not None:
        n_clients = tree_leaves(stacked)[0].shape[0]
        col_scale = w * _mask_n_eff(mask, n_clients, dev)
        w = None if mask is None else _client_weights(mask, None, dev)
    diag = {}
    flats = {"beta": [], "energy": [], "residual": []}
    client = {"energy": None, "flagged": None}

    def record(betas, energies, residuals, ce, cf):
        flats["beta"].append(betas.reshape(-1))
        flats["energy"].append(energies.reshape(-1))
        flats["residual"].append(residuals.reshape(-1))
        ce = torch.amax(ce, dim=0)
        cf = torch.amax(cf, dim=0)
        client["energy"] = ce if client["energy"] is None else torch.maximum(client["energy"], ce)
        client["flagged"] = cf if client["flagged"] is None else torch.maximum(client["flagged"], cf)

    def finish(out):
        diag.update({k: torch.cat(v) for k, v in flats.items()})
        if cfg.guard_energy_k > 0:
            diag["client_energy"] = client["energy"]
            diag["client_flagged"] = client["flagged"]
        return out, diag

    kw = dict(mask=mask, w=w, col_scale=col_scale)
    if cfg.joint_ab:
        idx = [0]

        def walk(node):
            if _is_ab_node(node):
                upd, betas, energies, residuals, ce, cf = _fedrpca_joint_ab(
                    node, cfg, shrink_fn, **kw
                )
                diag[f"pair{idx[0]}/beta_mean"] = torch.mean(betas)
                diag[f"pair{idx[0]}/energy_mean"] = torch.mean(energies)
                record(betas, energies, residuals, ce, cf)
                idx[0] += 1
                return upd
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(walk(v) for v in node)
            upd, betas, energies, residuals, ce, cf = _fedrpca_leaf(node, cfg, shrink_fn, **kw)
            record(betas, energies, residuals, ce, cf)
            return upd

        out = walk(stacked)
        return finish(out) if with_diagnostics else out

    leaves = tree_leaves(stacked)
    updates = []
    for i, leaf in enumerate(leaves):
        upd, betas, energies, residuals, ce, cf = _fedrpca_leaf(leaf, cfg, shrink_fn, **kw)
        updates.append(upd)
        diag[f"leaf{i}/beta_mean"] = torch.mean(betas)
        diag[f"leaf{i}/energy_mean"] = torch.mean(energies)
        record(betas, energies, residuals, ce, cf)
    out = tree_unflatten(stacked, updates)
    return finish(out) if with_diagnostics else out


def rpca_diag_summary(diag) -> dict:
    """Engine-agnostic scalar summary of fedrpca diagnostics (the packed
    engine's ``EngineDiagnostics`` or the reference path's dict)."""
    if hasattr(diag, "arrays"):
        out = {
            "beta_mean": diag.mean("beta"),
            "energy_mean": diag.mean("energy"),
            "rpca_residual_max": diag.max("residual"),
        }
        if "live_rank" in diag.arrays:
            out["live_rank_mean"] = diag.mean("live_rank")
        if "client_flagged" in diag.arrays:
            flags = functools.reduce(torch.maximum, diag.arrays["client_flagged"].values())
            out["guard_flagged"] = torch.sum(flags)
            out["client_energy_max"] = diag.max("client_energy")
        for k in (
            "fallback_count", "carry_hit_rate", "bytes_up",
            "bytes_down_basis", "uplink_hit_rate", "uplink_dense_falls",
        ):
            if k in diag.scalars:
                out[k] = diag.scalars[k]
        return out
    out = {
        "beta_mean": torch.mean(diag["beta"]),
        "energy_mean": torch.mean(diag["energy"]),
        "rpca_residual_max": torch.max(diag["residual"]),
    }
    if "client_flagged" in diag:
        out["guard_flagged"] = torch.sum(diag["client_flagged"])
        out["client_energy_max"] = torch.max(diag["client_energy"])
    return out


def client_flag_vector(diag):
    """Per-client sparse-energy quarantine flags (1 = flagged in at least
    one module) from either engine's diagnostics, or None with the guard
    off."""
    if hasattr(diag, "arrays"):
        if "client_flagged" not in diag.arrays:
            return None
        return functools.reduce(torch.maximum, diag.arrays["client_flagged"].values())
    if isinstance(diag, dict) and "client_flagged" in diag:
        return diag["client_flagged"]
    return None


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_SIMPLE = {
    "fedavg": lambda stacked, cfg, key, mask, weights: fedavg(
        stacked, mask=mask, weights=weights
    ),
    "task_arithmetic": lambda stacked, cfg, key, mask, weights: task_arithmetic(
        stacked, cfg.beta, mask=mask, weights=weights
    ),
    "ties": lambda stacked, cfg, key, mask, weights: ties_merging(
        stacked, cfg.ties_keep, cfg.ties_scale, mask=mask, weights=weights
    ),
    "fedexp": lambda stacked, cfg, key, mask, weights: fedexp(
        stacked, mask=mask, weights=weights
    ),
    "dare": lambda stacked, cfg, key, mask, weights: dare(
        stacked, cfg.dare_drop, key, mask=mask, weights=weights
    ),
}

ENGINES = ("packed", "reference")

#: Methods the port has.
METHODS = tuple(sorted([*_SIMPLE.keys(), "fedrpca"]))


def aggregate(
    stacked: Tree,
    cfg: Optional[AggregatorConfig] = None,
    shrink_fn: Callable = rpca_lib.soft_threshold,
    *,
    engine: str = "packed",
    key=None,
    mask=None,
    weights=None,
    with_diagnostics: bool = False,
    mesh=None,
    device="cuda",
):
    """Aggregate stacked client deltas per ``cfg.method`` on ``device``.

    ``stacked``, ``mask`` and ``weights`` move to ``device`` (default
    ``"cuda"``; without CUDA this raises unless the caller passes
    ``device="cpu"``), and the update comes back there.
    ``engine="packed"`` runs one batched call per shape bucket (CUDA tail
    kernels on the card); ``engine="reference"`` the per-leaf plain path.
    ``mask`` is a per-client validity vector (padded cohort slots 0);
    ``weights`` raw nonnegative per-client weights, mask-zeroed and
    normalized here.  ``key`` (an int or a sequence of ints) seeds dare,
    which requires it; both engines draw the same keep masks from it.

    ``mesh`` (a ``launch.mesh.ClientMesh``) shards the packed client axis of
    the packed engine; the work then runs on the mesh's devices, the
    replicated part on its first, where the update comes back.  The mesh's
    device type must be ``device``'s.  The reference engine is the
    unsharded parity oracle: a multi-shard mesh with it raises, a one-shard
    mesh is ignored on both engines.
    """
    cfg = cfg or AggregatorConfig()
    if cfg.weighting not in WEIGHTINGS:
        raise ValueError(f"unknown weighting: {cfg.weighting!r} (expected one of {WEIGHTINGS})")
    if cfg.carry_mode not in CARRY_MODES:
        raise ValueError(f"unknown carry_mode: {cfg.carry_mode!r} (expected one of {CARRY_MODES})")
    if cfg.svt_mode not in rpca_lib.SVT_MODES:
        raise ValueError(
            f"unknown svt_mode: {cfg.svt_mode!r} (expected one of {rpca_lib.SVT_MODES})"
        )
    if cfg.method == "dare" and key is None:
        raise ValueError("dare requires an explicit PRNG key (got key=None)")
    dev = backend.resolve_device(device)
    if rpca_lib.mesh_client_shards(mesh) > 1:
        if engine == "reference":
            raise ValueError(
                "the reference engine is the single-device parity oracle and "
                "cannot shard the client axis; use engine='packed' with a mesh"
            )
        if mesh.devices[0].type != dev.type:
            raise ValueError(f"a mesh on {mesh.devices[0]} cannot aggregate on {dev}")
        dev = mesh.devices[0]
    stacked = tree_to(stacked, dev)
    mask = None if mask is None else torch.as_tensor(mask, device=dev)
    weights = None if weights is None else torch.as_tensor(weights, device=dev)
    if engine == "packed":
        from repro_torch.core import engine as engine_lib

        return engine_lib.aggregate_packed(
            stacked, cfg, shrink_fn=shrink_fn, key=key, mask=mask, weights=weights,
            with_diagnostics=with_diagnostics, mesh=mesh,
        )
    if engine != "reference":
        raise ValueError(f"unknown engine: {engine!r} (expected one of {ENGINES})")
    if cfg.method in _SIMPLE:
        out = _SIMPLE[cfg.method](stacked, cfg, key, mask, weights)
        return (out, {}) if with_diagnostics else out
    if cfg.method == "fedrpca":
        return fedrpca(
            stacked, cfg, shrink_fn, with_diagnostics=with_diagnostics, mask=mask, weights=weights,
        )
    raise ValueError(f"unknown aggregation method: {cfg.method!r}")
