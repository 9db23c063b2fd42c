"""Dirichlet non-IID data partitioning (Hsu et al. 2019 — the paper's setup).

Port of the numpy part of ``repro/fed/partition.py`` (kept as a copy: the
port imports nothing of the JAX package).  Heterogeneous client ranks are
ROADMAP.md queue 1, item 6.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    rng: np.random.Generator,
    min_per_client: int = 2,
) -> List[np.ndarray]:
    """Split example indices across clients with Dirichlet(alpha) label skew.

    For each class c, draw p ~ Dir(alpha * 1_M) and send that class's
    examples to clients proportionally; retry until every client holds at
    least ``min_per_client`` examples, then top up from the largest.
    """
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_per_client: List[list] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_per_client:
            return [np.asarray(sorted(ix)) for ix in idx_per_client]
    order = np.argsort(sizes)
    donor = order[-1]
    for i in order:
        while len(idx_per_client[i]) < min_per_client and len(idx_per_client[donor]) > min_per_client:
            idx_per_client[i].append(idx_per_client[donor].pop())
    return [np.asarray(sorted(ix)) for ix in idx_per_client]


def client_sizes(parts: List[np.ndarray]) -> np.ndarray:
    """(n_clients,) local dataset sizes of a partition."""
    return np.asarray([len(ix) for ix in parts], np.int64)


def data_size_weights(parts: List[np.ndarray]) -> np.ndarray:
    """Normalized FedAvg weights n_k / n (Eq. 4) for a partition."""
    sizes = client_sizes(parts).astype(np.float64)
    total = sizes.sum()
    if total <= 0:
        raise ValueError("empty partition: no examples across clients")
    return sizes / total


def label_distribution(labels: np.ndarray, parts: List[np.ndarray], n_classes: int) -> np.ndarray:
    """(n_clients, n_classes) empirical label histogram per client."""
    out = np.zeros((len(parts), n_classes))
    for i, ix in enumerate(parts):
        if len(ix):
            binc = np.bincount(labels[ix], minlength=n_classes)
            out[i] = binc / binc.sum()
    return out
