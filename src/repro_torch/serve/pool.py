"""Paged adapter pool: slot-allocated LoRA trees with in-place hot-swap
(port of ``repro/serve/pool.py``).

Every LoRA leaf of the model's adapter tree gains a leading ``n_slots`` axis,
so a mixed-tenant batch is served by each request naming its slot, never by
re-stacking adapter trees.  On this path the gathered kernel
(``kernels.gathered_lora_matmul``) reads each layer's slice of the pool in
place, through its slot stride.

Hot-swap contract: ``publish`` writes one slot with ``copy_`` under
``torch.no_grad()``, so the pooled tensors keep their storage across
publishes — a serving loop holding the pool (or a view of it) sees the new
weights at its next call with nothing re-created.  This is the eager
counterpart of the reference's "publish never invalidates the jitted
consumer"; nothing compiles here, so the reference's ``retrace_count`` has
no counterpart.

Heterogeneous ranks: a published tree whose leaves are narrower than the
pool template is zero-padded; zero A/B columns multiply away exactly.
Admission and eviction are LRU by default (``policy="traffic"`` evicts the
lowest-traffic slot); ``acquire`` updates both keys.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

log = logging.getLogger("repro_torch.serve.pool")


def adapter_view(pooled, slots: torch.Tensor):
    """Per-request adapters for ``models.forward``, without a copy.

    The reference gathers each group leaf to ``(n_groups, B, ...)``.  Here
    each adapter node ``{"A", "B"}`` keeps the pool's slot axis, moved
    second — ``A: (n_groups, n_slots, d_in, r)``, a view — and gains
    ``"slots": slots``; ``layers.dense`` hands layer g's ``(n_slots, d_in, r)``
    slice and the slots to the gathered kernel.  ``view[...]["A"][:, slots]``
    is the reference's leaf.  Tail leaves keep ``(n_slots, ...)``.
    """
    slots = torch.as_tensor(slots, dtype=torch.int32)

    def walk(node, move):
        if isinstance(node, dict) and "A" in node and "B" in node:
            out = {k: (v.movedim(0, 1) if move else v) for k, v in node.items()}
            out["slots"] = slots.to(node["A"].device)
            return out
        if isinstance(node, dict):
            return {k: walk(v, move) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, move) for v in node)
        return node

    return {"groups": walk(pooled["groups"], True), "tail": walk(pooled["tail"], False)}


def merged_view(pooled, occupancy: torch.Tensor):
    """Occupancy-weighted mean adapter (the single-tenant ``--merged`` path)."""
    denom = torch.clamp_min(occupancy.sum(), 1.0)

    def mean(leaf):
        w = occupancy.to(leaf.device, leaf.dtype).reshape((-1,) + (1,) * (leaf.ndim - 1))
        return torch.sum(leaf * w, dim=0) / denom.to(leaf.device, leaf.dtype)

    return tree_map(mean, pooled)


def _pad_to(leaf: torch.Tensor, target_shape) -> torch.Tensor:
    if tuple(leaf.shape) == tuple(target_shape):
        return leaf
    if leaf.ndim != len(target_shape):
        raise ValueError(f"adapter leaf {tuple(leaf.shape)} does not match the pool "
                         f"template {tuple(target_shape)}")
    pad = []
    for have, want in zip(reversed(leaf.shape), reversed(target_shape)):
        if have > want:
            raise ValueError(f"adapter leaf {tuple(leaf.shape)} exceeds pool template "
                             f"{tuple(target_shape)}")
        pad += [0, want - have]
    return torch.nn.functional.pad(leaf, pad)


class AdapterPool:
    """Fixed-capacity pool of LoRA adapter trees on the template's device.

    Args:
      template: a lora tree (e.g. ``init_lora_params(cfg)``) whose leaf
        shapes, dtypes and device define one slot.  Pool leaves are
        ``(n_slots, *leaf.shape)``, zero-initialised (an empty slot is an
        exact no-op adapter).
      n_slots: pool capacity.
      policy: ``"lru"`` (default) or ``"traffic"`` eviction keying.
    """

    def __init__(self, template, n_slots: int, *, policy: str = "lru"):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if policy not in ("lru", "traffic"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.n_slots = n_slots
        self.policy = policy
        self._template_shapes = tree_map(lambda l: tuple(l.shape), template)
        self.pooled = tree_map(
            lambda l: torch.zeros((n_slots,) + tuple(l.shape), dtype=l.dtype, device=l.device),
            template,
        )
        leaves = tree_leaves(self.pooled)
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self._slot_of: Dict[object, int] = {}
        self._id_of: List[Optional[object]] = [None] * n_slots
        self._last_used = [0] * n_slots
        self._traffic = [0] * n_slots
        self._tick = 0
        self.publishes = 0
        self.evictions = 0

    # -- bookkeeping ---------------------------------------------------

    def __contains__(self, adapter_id) -> bool:
        return adapter_id in self._slot_of

    def __len__(self) -> int:
        return len(self._slot_of)

    def slot_map(self) -> Dict[object, int]:
        return dict(self._slot_of)

    def occupancy(self) -> torch.Tensor:
        return torch.tensor([1.0 if i is not None else 0.0 for i in self._id_of],
                            dtype=torch.float32, device=self.device)

    def _touch(self, slot: int, traffic: int = 0):
        self._tick += 1
        self._last_used[slot] = self._tick
        self._traffic[slot] += traffic

    def _evict_candidate(self) -> int:
        key = self._last_used if self.policy == "lru" else self._traffic
        occupied = [s for s in range(self.n_slots) if self._id_of[s] is not None]
        return min(occupied, key=lambda s: (key[s], s))

    def _alloc(self, adapter_id) -> int:
        if adapter_id in self._slot_of:
            return self._slot_of[adapter_id]
        for slot in range(self.n_slots):
            if self._id_of[slot] is None:
                break
        else:
            slot = self._evict_candidate()
            evicted = self._id_of[slot]
            del self._slot_of[evicted]
            self.evictions += 1
            log.info("pool full: evicting adapter %r from slot %d (%s)",
                     evicted, slot, self.policy)
        self._slot_of[adapter_id] = slot
        self._id_of[slot] = adapter_id
        self._traffic[slot] = 0
        return slot

    # -- data path -----------------------------------------------------

    def publish(self, adapter_id, lora_tree) -> int:
        """Admit/overwrite ``adapter_id`` with ``lora_tree``; returns its slot.

        The slot is written in place; narrower leaves are zero-padded and
        structure mismatches raise before anything is written.
        """
        padded = tree_map(_pad_to, lora_tree, self._template_shapes)
        slot = self._alloc(adapter_id)
        with torch.no_grad():
            tree_map(lambda p, t: p[slot].copy_(t), self.pooled, padded)
        self._touch(slot)
        self.publishes += 1
        return slot

    def publish_round(self, adapter_id, base_tree, update_tree, lr: float = 1.0):
        """fed->serve in one call: apply an aggregated update to the
        tenant's current adapter tree and hot-swap the result into its slot.
        Returns the new tree.

        Refuses non-finite updates: a NaN/Inf leaf would poison the slot for
        every request routed to it, so the update is checked before anything
        is written (the tenant keeps serving its previous adapter).
        """
        bad = []

        def check(path, node):
            if isinstance(node, dict):
                for k in sorted(node):
                    check(f"{path}[{k!r}]", node[k])
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    check(f"{path}[{i}]", v)
            elif not bool(torch.isfinite(node).all()):
                bad.append(path)

        check("", update_tree)
        if bad:
            raise ValueError(
                f"refusing to publish round update for adapter {adapter_id!r}: "
                f"non-finite leaves {bad}"
            )
        new_tree = tree_map(lambda g, u: (g + lr * u.to(g.dtype)).to(g.dtype),
                            base_tree, update_tree)
        self.publish(adapter_id, new_tree)
        return new_tree

    def acquire(self, adapter_ids) -> torch.Tensor:
        """Resolve a batch of adapter ids to pool slots ((B,) int32 on the
        pool's device).  Ids must be resident; each hit bumps the slot's
        recency and traffic counters."""
        slots = []
        for aid in adapter_ids:
            if aid not in self._slot_of:
                raise KeyError(f"adapter {aid!r} not resident — publish() it before serving")
            slot = self._slot_of[aid]
            self._touch(slot, traffic=1)
            slots.append(slot)
        return torch.tensor(slots, dtype=torch.int32, device=self.device)

    def view(self, slots: torch.Tensor):
        """``adapter_view`` of this pool."""
        return adapter_view(self.pooled, slots)

    def merged(self):
        """Mean over resident adapters."""
        return merged_view(self.pooled, self.occupancy())
