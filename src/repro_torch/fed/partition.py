"""Dirichlet non-IID data partitioning (Hsu et al. 2019 — the paper's setup).

Port of ``repro/fed/partition.py`` (kept as a copy: the port imports
nothing of the JAX package), with the heterogeneous client-rank helpers
(``parse_client_ranks``, ``infer_lora_rank``, ``client_rank_masks``).
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map


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


# ---------------------------------------------------------------------------
# Heterogeneous per-client LoRA ranks
# ---------------------------------------------------------------------------


def parse_client_ranks(spec, n_clients: int, max_rank: int) -> np.ndarray:
    """Parse a ``--client-ranks`` declaration into (n_clients,) int32 ranks.

    ``spec`` is a comma-separated int list (cycled when shorter than the
    cohort: ``"8,4"`` over 6 clients is ``8,4,8,4,8,4``) or an int
    sequence of the same meaning.  Every rank must satisfy
    ``1 <= rank <= max_rank`` (the template's LoRA rank).
    """
    if isinstance(spec, str):
        try:
            ranks = [int(p) for p in spec.split(",") if p.strip()]
        except ValueError as e:
            raise ValueError(f"malformed client-ranks spec: {spec!r}") from e
    else:
        ranks = [int(r) for r in spec]
    if not ranks:
        raise ValueError("empty client-ranks spec")
    out = np.asarray([ranks[i % len(ranks)] for i in range(n_clients)], np.int32)
    if out.min() < 1 or out.max() > max_rank:
        raise ValueError(
            f"client ranks must lie in [1, {max_rank}] (the template's LoRA "
            f"rank); got {sorted(set(out.tolist()))}"
        )
    return out


def infer_lora_rank(template: Any) -> int:
    """The template's LoRA rank: the trailing axis of A in its first
    ``{"A", "B"}`` adapter node (dict keys in insertion order)."""
    found: list = []

    def walk(node):
        if found:
            return
        if isinstance(node, dict) and set(node) >= {"A", "B"}:
            found.append(int(node["A"].shape[-1]))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(template)
    if not found:
        raise ValueError(
            "could not infer the LoRA rank: no {'A', 'B'} adapter node in "
            "the template (pass explicit rank masks instead)"
        )
    return found[0]


def client_rank_masks(template: Any, ranks, lora_rank: int | None = None) -> Any:
    """Stacked 0/1 float32 masks zeroing each client's delta beyond its
    declared rank: a tree of ``(n_clients, *leaf.shape)`` masks on the
    leaves' devices, where every axis of size ``lora_rank`` (A's trailing
    axis, B's row axis) keeps only the first ``ranks[i]`` slices for client
    ``i``.  Multiplying the stacked deltas by them gives the deltas that
    rank-``r_i`` clients zero-padded into the uniform layout would ship."""
    ranks_t = torch.as_tensor(np.asarray(ranks, np.int32))
    n = int(ranks_t.shape[0])
    r_dim = infer_lora_rank(template) if lora_rank is None else int(lora_rank)

    def leaf_mask(leaf):
        shape = tuple(leaf.shape)
        rk = ranks_t.to(leaf.device)
        m = torch.ones((n, *shape), dtype=torch.float32, device=leaf.device)
        for ax, s in enumerate(shape):
            if s == r_dim:
                iota = torch.arange(s, device=leaf.device).reshape(
                    (1,) + (1,) * ax + (s,) + (1,) * (len(shape) - ax - 1))
                keep = iota < rk.reshape((n,) + (1,) * len(shape))
                m = m * keep.to(torch.float32)
        return m

    return tree_map(leaf_mask, template)
