"""Diagnostics used by the paper's figures (cosine-similarity structure, E^t).

Port of ``repro/core/metrics.py``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.pytree import tree_flatten_to_vector, tree_leaves, tree_map

Tree = Any


def pairwise_cosine(matrix: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity between the columns of ``matrix`` (vec, n)."""
    norms = torch.linalg.vector_norm(matrix, dim=0, keepdim=True)
    normalized = matrix / torch.clamp_min(norms, 1e-12)
    return normalized.T @ normalized


def client_update_cosine(stacked: Tree) -> torch.Tensor:
    """Fig. 1a: cosine-similarity matrix of whole-update vectors per client."""
    n_clients = tree_leaves(stacked)[0].shape[0]
    vecs = torch.stack(
        [tree_flatten_to_vector(tree_map(lambda x: x[i], stacked)) for i in range(n_clients)],
        dim=1,
    )
    return pairwise_cosine(vecs)


def mean_offdiag(sim: torch.Tensor) -> torch.Tensor:
    """Average pairwise (off-diagonal) similarity — the Fig. 1 summary number."""
    n = sim.shape[0]
    mask = 1.0 - torch.eye(n, dtype=sim.dtype, device=sim.device)
    return torch.sum(sim * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def sparsity_fraction(x: torch.Tensor, rel_tol: float = 1e-6) -> torch.Tensor:
    """Fraction of entries that are (relatively) zero — S should be sparse."""
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12)
    return torch.mean((torch.abs(x) <= rel_tol * scale).to(torch.float32))


def effective_rank(x: torch.Tensor, rel_tol: float = 1e-3) -> torch.Tensor:
    """Number of singular values above rel_tol * sigma_max — L should be low-rank."""
    s = torch.linalg.svdvals(x)
    return torch.sum((s > rel_tol * torch.clamp_min(s[0], 1e-12)).to(torch.int32))
