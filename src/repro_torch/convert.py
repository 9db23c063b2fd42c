"""Carry the JAX package's parameters across as numpy arrays.

``from_jax_tree`` takes any nest of dicts / lists / tuples / NamedTuples
whose leaves are array-likes (JAX arrays, numpy arrays) and returns the
same nest of tensors on ``device``; ``to_numpy_tree`` is its inverse.  No
JAX import is needed: a JAX array converts through ``numpy.asarray``.
Used for the synth task's frozen ``base`` (``W0``, ``H``), LoRA trees and
stacked client-delta trees, so the port computes on exactly the
reference's weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map


def from_jax_tree(tree: Any, device="cpu") -> Any:
    """Array-like leaves -> tensors on ``device`` (dtype kept, bits kept)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def to_numpy_tree(tree: Any) -> Any:
    """Tensor leaves -> numpy arrays (moved to the CPU, bits kept)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
