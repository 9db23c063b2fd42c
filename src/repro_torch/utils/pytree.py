"""Tree helpers used across the port.

A tree is a nest of dicts, lists and tuples whose leaves are tensors (the
port's LoRA parameters and stacked client deltas).  Leaf order is the
JAX package's: dict keys sorted, sequences in order — so flattening a
tree gives the same vector as ``repro.utils.pytree.tree_flatten_to_vector``
on the matching JAX pytree.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def tree_leaves(tree: Tree) -> list:
    """Leaves in the JAX package's order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Tree, path: tuple = ()) -> Tree:
    """Apply ``fn(path, leaf)`` leafwise; ``path`` is the tuple of names from
    the root: dict keys, sequence indices as strings and NamedTuple field
    names (the names ``jax.tree_util`` paths carry)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, (*path, f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, (*path, str(i))) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_unflatten(like: Tree, leaves: list) -> Tree:
    """Rebuild ``like``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            built = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [rebuild(v) for v in node]
            return type(node)(*out) if hasattr(node, "_fields") else type(node)(out)
        return next(it)

    return rebuild(like)


def tree_flatten_to_vector(tree: Tree) -> torch.Tensor:
    """``vec(.)`` over a whole tree: concatenated raveled leaves."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([x.reshape(-1) for x in leaves])


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    parts = [torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_to(tree: Tree, device) -> Tree:
    return tree_map(lambda x: x.to(device), tree)
