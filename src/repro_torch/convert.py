"""Carry the JAX package's parameters across as numpy arrays.

``from_jax_tree`` takes any nest of dicts / lists / tuples / NamedTuples
whose leaves are array-likes (JAX arrays, numpy arrays) and returns the
same nest of tensors on ``device``; ``to_numpy_tree`` is its inverse.  No
JAX import is needed: a JAX array converts through ``numpy.asarray``.
Used for the synth task's frozen ``base`` (``W0``, ``H``), LoRA trees and
stacked client-delta trees, so the port computes on exactly the
reference's weights.  ``model_from_jax`` carries a whole base model across:
the reference's ``init_params`` tree into the port's ``DecoderLM``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map


def from_jax_tree(tree: Any, device="cpu") -> Any:
    """Array-like leaves -> tensors on ``device`` (dtype kept, bits kept)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def model_from_jax(params: Any, cfg, device="cpu"):
    """The reference's base-model tree (``repro.models.init_params``, leaves
    array-likes) as the port's ``DecoderLM`` on ``device``.  The reference
    stacks layer ``i`` at group ``i // unit`` of pattern slot ``i % unit``
    and keeps the layers past the last whole unit unstacked in ``tail``
    (layer ``n_groups * unit + j`` is ``params["tail"][j]``); here each
    layer is its own ``Block``.  An encoder-decoder config's encoder stacks
    its layers in one group (``params["encoder"]["groups"][0]``, layer ``i``
    at index ``i``) beside its ``final_norm`` and ``pos_embed``; the
    decoder's ``pos_embed``, cross sub-blocks and biases sit where the
    module names say.  Bits are kept."""
    from repro_torch.models.model import DecoderLM

    model = DecoderLM(cfg, None, device=device)
    unit = len(cfg.layer_pattern)
    n_grouped = cfg.n_pattern_groups * unit
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = name.split(".")
            if path[:2] == ["encoder", "layers"]:
                node, index, path = params["encoder"]["groups"][0], int(path[2]), path[3:]
            elif path[0] == "layers" and int(path[1]) >= n_grouped:
                node, path, index = params["tail"][int(path[1]) - n_grouped], path[2:], None
            elif path[0] == "layers":
                i = int(path[1])
                node, path, index = params["groups"][i % unit], path[2:], i // unit
            else:
                node, index = params, None
            for key in path:
                node = node[key]
            leaf = np.asarray(node if index is None else np.asarray(node)[index])
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference leaf {leaf.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf, copy=True)))
    return model


def to_numpy_tree(tree: Any) -> Any:
    """Tensor leaves -> numpy arrays (moved to the CPU, bits kept)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
