"""Client-update stacking utilities (the paper's Eq. 7-8).

Port of ``repro/core/stacking.py``.  The server receives per-client LoRA
delta trees; aggregation needs, per LoRA matrix, the column-stacked
``M = [vec(d_1) ... vec(d_M)]``.  ``leaf_matrices`` turns a stacked leaf
``(n_clients, *module_axes, *mat)`` into a batch ``(modules, vec, n_clients)``
of those matrices; the rest pads buckets and cohorts to canonical sizes.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.utils.pytree import tree_map

Tree = Any


def stack_client_trees(trees: List[Tree]) -> Tree:
    """Stack a list of identically-structured trees on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def unstack_client_tree(stacked: Tree, index: int) -> Tree:
    return tree_map(lambda x: x[index], stacked)


def infer_layer_axes(leaf: torch.Tensor) -> int:
    """LoRA module weights are 2-D, so a stacked leaf is (clients, r, d) ->
    0 layer axes, (clients, layers, r, d) -> 1; higher ranks keep every
    middle axis as a module axis."""
    return max(leaf.ndim - 3, 0)


def leaf_matrices(leaf: torch.Tensor, layer_axes: int | None = None) -> torch.Tensor:
    """(clients, *module_axes, *mat) -> (prod(module_axes), vec_dim, clients)."""
    if layer_axes is None:
        layer_axes = infer_layer_axes(leaf)
    n_clients = leaf.shape[0]
    n_modules = 1
    for s in leaf.shape[1 : 1 + layer_axes]:
        n_modules *= s
    flat = leaf.reshape(n_clients, n_modules, -1)
    return flat.permute(1, 2, 0)


#: Canonical bucket vec dims of the batched engine: small LoRA matrices pad
#: up to the next one, so arbitrary (r, d) combinations share a few buckets.
CANONICAL_VEC_DIMS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def canonical_vec_dim(vec_dim: int) -> int:
    """Smallest canonical bucket size >= vec_dim (8192-multiples above)."""
    for c in CANONICAL_VEC_DIMS:
        if vec_dim <= c:
            return c
    step = CANONICAL_VEC_DIMS[-1]
    return -(-vec_dim // step) * step


#: Canonical cohort sizes for shape-static partial participation: powers of
#: two up to the cap, then cap-multiples.
CANONICAL_COHORT_CAP = 128


def canonical_cohort_size(n_clients: int) -> int:
    """Smallest canonical cohort size >= n_clients."""
    if n_clients <= 0:
        raise ValueError(f"cohort size must be positive, got {n_clients}")
    p = 1
    while p < n_clients and p < CANONICAL_COHORT_CAP:
        p *= 2
    if p >= n_clients:
        return p
    return -(-n_clients // CANONICAL_COHORT_CAP) * CANONICAL_COHORT_CAP


def pad_cohort(stacked: Tree, target: int) -> Tree:
    """Zero-pad every leaf's leading client axis up to ``target`` slots (the
    padded slots must then be masked out of aggregation)."""

    def pad_leaf(x):
        pad = target - x.shape[0]
        if pad < 0:
            raise ValueError(f"cohort target {target} < client count {x.shape[0]}")
        if pad == 0:
            return x
        zeros = torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, zeros], dim=0)

    return tree_map(pad_leaf, stacked)


def pad_matrices(mats: torch.Tensor, target_vec: int) -> torch.Tensor:
    """Zero-pad (modules, vec, clients) matrices along vec up to target_vec."""
    pad = target_vec - mats.shape[1]
    if pad < 0:
        raise ValueError(f"target {target_vec} < vec dim {mats.shape[1]}")
    if pad == 0:
        return mats
    return torch.nn.functional.pad(mats, (0, 0, 0, pad))


def matrices_to_leaf_update(
    columns_mean: torch.Tensor, leaf: torch.Tensor, layer_axes: int | None = None
) -> torch.Tensor:
    """Inverse reshape of an aggregated (modules, vec_dim) update to the
    shape of one client's delta ``leaf[0]``."""
    return columns_mean.reshape(leaf.shape[1:]).to(leaf.dtype)
