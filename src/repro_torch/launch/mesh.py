"""Client meshes for mesh-sharded aggregation, and the production mesh as
data.

The port's counterpart of what ``repro/launch/mesh.py`` gives the sharded
aggregation.  The reference is single-controller: one process drives a
``shard_map`` over the client axis of a device mesh.  The port keeps that
model without a multi-process runtime.  A ``ClientMesh`` is an ordered tuple
of devices, one per shard of a bucket's packed client axis; one process
holds every shard's tensors in a list (shard k's on ``devices[k]``) and
loops over the shards.  The two collectives the sharded loop needs are
methods of the mesh, and both are deterministic: the same parts give the
same bits on every call.

The reference's production meshes, (16, 16) and (2, 16, 16) chips, are
``MeshConfig`` data here (``make_production_mesh``): the dry run reckons
layouts and costs on them, and one card builds no such mesh.

Nothing here touches a device when the module is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.config import MeshConfig
from repro_torch.kernels import backend


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """Shard k of the packed client axis lives on ``devices[k]``; values
    that every shard shares (replicated) are computed on ``devices[0]``."""

    devices: tuple

    @property
    def shards(self) -> int:
        return len(self.devices)

    def replicate(self, t: torch.Tensor) -> list:
        """``t`` handed to every shard: one tensor per shard, on its device."""
        return [t.to(dev) for dev in self.devices]

    def psum(self, parts: Sequence[torch.Tensor]) -> list:
        """Sum of the shards' parts, added on the first shard's device in
        shard order, then handed to every shard."""
        d0 = self.devices[0]
        total = parts[0].to(d0)
        for p in parts[1:]:
            total = total + p.to(d0)
        return self.replicate(total)

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The shards' parts concatenated along ``dim`` in shard order, on the
        first shard's device."""
        d0 = self.devices[0]
        return torch.cat([p.to(d0) for p in parts], dim=dim)


def make_host_mesh(n: int, device="cuda") -> ClientMesh:
    """A mesh of ``n`` client shards.  On CUDA, shard k goes to
    ``cuda:(k % torch.cuda.device_count())``: ``n`` shards on the one card of
    a one-card machine, one shard a card on a machine with ``n`` cards.
    Without CUDA this raises unless ``device="cpu"``, where every shard lies
    on the CPU."""
    if n < 1:
        raise ValueError(f"mesh shard count must be >= 1, got {n}")
    dev = backend.resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        return ClientMesh(tuple(torch.device("cuda", k % count) for k in range(n)))
    return ClientMesh((dev,) * n)


def make_debug_mesh(device="cuda") -> ClientMesh:
    """A one-shard mesh, for smoke runs of the mesh code path."""
    return make_host_mesh(1, device)


def client_shard_count(mesh: ClientMesh | None) -> int:
    """Number of shards of the packed client axis under ``mesh``.

    ``None`` and any one-shard mesh report exactly one shard, and callers
    must then take the unsharded code path (the sharded loop delegates, so
    the one-shard result is bit for bit the unsharded one)."""
    return 1 if mesh is None else mesh.shards


def make_production_mesh(*, multi_pod: bool = False) -> MeshConfig:
    """The reference's production mesh as data: single pod (16, 16) = 256
    chips over ("data", "model"), multi-pod (2, 16, 16) = 512 chips over
    ("pod", "data", "model")."""
    return MeshConfig(multi_pod=multi_pod)


def client_axes(mesh: MeshConfig) -> tuple:
    """The mesh axes the clients (and batches) shard over."""
    return tuple(a for a in mesh.axes if a in ("pod", "data"))
