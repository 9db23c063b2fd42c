"""Batched aggregation engine: shape-bucketed leaf packing + one call per bucket.

Port of ``repro/core/engine.py``:

  1. ``pack`` walks a stacked delta tree once, turns each leaf into its
     (modules, vec_dim, n_clients) matrices, zero-pads vec_dim up to a
     canonical bucket size and concatenates everything that shares a
     ``(padded_vec, n_clients, dtype)`` key into one bucket tensor.  The
     returned ``PackSpec`` is invertible (``unpack``).
  2. Every method runs as one batched call per bucket — a mean, or one
     ``robust_pca_bucket`` loop whose tail is the CUDA kernels on the card.
  3. Per-module diagnostics come back as (modules,) tensors keyed by bucket.

Zero padding is lossless: zero rows add nothing to means or Gram matrices
and stay exactly zero through the SVT and the shrink, and the ADMM
constants use each module's true vec dim.  ``mesh=`` (a
``launch.mesh.ClientMesh`` of more than one shard) runs fedrpca's RPCA as
``rpca.robust_pca_bucket_sharded``.  Sessions and plans
(``plan_aggregation``, ``AggSession``, carries, re-tiering) are ROADMAP.md
queue 1, item 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import rpca as rpca_lib
from repro_torch.core import stacking
from repro_torch.core.aggregators import (
    AggregatorConfig,
    _client_weights,
    _is_ab_node,
    sparse_energy_ratio,
)
from repro_torch.utils.pytree import tree_leaves

Tree = Any

# Bucket key: (padded_vec_dim, n_clients, dtype_name).
BucketKey = tuple


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class PackEntry:
    """One packed tree node: a plain leaf or a joint (A, B) adapter pair."""

    kind: str  # "leaf" | "ab_pair"
    path: tuple  # tree path of dict keys / sequence indices
    bucket: BucketKey
    offset: int  # first module row of this entry within its bucket
    n_modules: int
    vec_dim: int  # true (unpadded) vec dim; ab_pair: va + vb
    shapes: tuple  # per-part one-client delta shapes (1 part, or A and B)
    dtypes: tuple  # matching per-part dtypes
    split: tuple  # vec-dim split points between parts (ab_pair: (va,))


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static, invertible description of one packing (the unpack program)."""

    entries: tuple
    skeleton: Any  # original structure with entry indices at leaf positions
    n_clients: int  # original (pre-padding) cohort size
    bucket_dims: Mapping[BucketKey, tuple]  # key -> (total_modules, padded_vec)
    cohort_size: int = 0  # padded client-axis length


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One shape bucket: the packed tensor + per-module true vec dims, with
    the cohort validity mask and normalized weights (None on the dense
    unweighted path; masked columns of ``data`` are already zero)."""

    data: torch.Tensor  # (total_modules, padded_vec, cohort_size)
    true_dims: torch.Tensor  # (total_modules,) int32
    dims: tuple = ()  # the same true dims as Python ints
    client_mask: torch.Tensor | None = None  # (cohort_size,) float32
    weights: torch.Tensor | None = None  # (cohort_size,) float32, normalized


def pack(
    stacked: Tree,
    *,
    granularity: str = "module",
    joint_ab: bool = False,
    client_mask=None,
    weights=None,
    cohort_size: int | None = None,
    mesh=None,
) -> tuple[dict, PackSpec]:
    """Pack a stacked client-delta tree into shape buckets.

    ``granularity="module"`` splits scan-stacked leaves along their layer
    axes (the fedrpca layout); ``"leaf"`` keeps each leaf one flattened
    matrix.  ``joint_ab`` concatenates each ``{"A", "B"}`` node's vec dims
    into one joint matrix (App. B.2).  ``client_mask`` zeroes padded client
    columns; ``weights`` ride on the buckets; ``cohort_size`` zero-pads the
    client axis and extends the mask with zeros.  ``mesh`` places nothing:
    the sharded loop owns the column layout, and a one-shard mesh is the
    unsharded packing.
    """
    if granularity not in ("module", "leaf"):
        raise ValueError(f"unknown granularity: {granularity!r}")
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("pack: empty pytree")
    dev = leaves[0].device
    orig_clients = None
    if cohort_size is not None:
        orig_clients = int(leaves[0].shape[0])
        pad_c = cohort_size - orig_clients
        if pad_c < 0:
            raise ValueError(f"cohort_size {cohort_size} < client count {orig_clients}")
        if pad_c:
            stacked = stacking.pad_cohort(stacked, cohort_size)
            zeros = torch.zeros((pad_c,), dtype=torch.float32, device=dev)
            base = (
                torch.ones((orig_clients,), dtype=torch.float32, device=dev)
                if client_mask is None
                else torch.as_tensor(client_mask, dtype=torch.float32, device=dev)
            )
            client_mask = torch.cat([base, zeros])
            if weights is not None:
                weights = torch.cat(
                    [torch.as_tensor(weights, dtype=torch.float32, device=dev), zeros]
                )
    entries: list[PackEntry] = []
    mats_by_bucket: dict[BucketKey, list] = {}
    dims_by_bucket: dict[BucketKey, list] = {}
    offsets: dict[BucketKey, int] = {}
    n_clients_seen: list[int] = []

    def add_matrices(mats, vec_dim, dtype):
        nc = mats.shape[-1]
        n_clients_seen.append(nc)
        padded = stacking.canonical_vec_dim(vec_dim)
        key = (padded, nc, _dtype_name(dtype))
        off = offsets.get(key, 0)
        mats_by_bucket.setdefault(key, []).append(
            stacking.pad_matrices(mats.to(dtype), padded)
        )
        dims_by_bucket.setdefault(key, []).extend([vec_dim] * mats.shape[0])
        offsets[key] = off + mats.shape[0]
        return key, off

    def walk(node, path):
        if joint_ab and _is_ab_node(node):
            a, b = node["A"], node["B"]
            mats_a = stacking.leaf_matrices(a)
            mats_b = stacking.leaf_matrices(b)
            if mats_a.shape[0] != mats_b.shape[0]:
                raise ValueError(
                    f"(A, B) module counts differ at {path}: "
                    f"{mats_a.shape[0]} vs {mats_b.shape[0]}"
                )
            dtype = torch.promote_types(a.dtype, b.dtype)
            joint = torch.cat([mats_a.to(dtype), mats_b.to(dtype)], dim=1)
            key, off = add_matrices(joint, joint.shape[1], dtype)
            entries.append(PackEntry(
                kind="ab_pair", path=path, bucket=key, offset=off,
                n_modules=joint.shape[0], vec_dim=joint.shape[1],
                shapes=(tuple(a.shape[1:]), tuple(b.shape[1:])),
                dtypes=(a.dtype, b.dtype), split=(mats_a.shape[1],),
            ))
            return len(entries) - 1
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            walked = [walk(v, path + (i,)) for i, v in enumerate(node)]
            if hasattr(node, "_fields"):
                return type(node)(*walked)
            return type(node)(walked)
        layer_axes = None if granularity == "module" else 0
        mats = stacking.leaf_matrices(node, layer_axes)
        key, off = add_matrices(mats, mats.shape[1], node.dtype)
        entries.append(PackEntry(
            kind="leaf", path=path, bucket=key, offset=off,
            n_modules=mats.shape[0], vec_dim=mats.shape[1],
            shapes=(tuple(node.shape[1:]),), dtypes=(node.dtype,), split=(),
        ))
        return len(entries) - 1

    skeleton = walk(stacked, ())
    if len(set(n_clients_seen)) != 1:
        raise ValueError(f"inconsistent client counts across leaves: {set(n_clients_seen)}")

    mask32 = None if client_mask is None else torch.as_tensor(
        client_mask, dtype=torch.float32, device=dev)
    w32 = None if weights is None else torch.as_tensor(weights, dtype=torch.float32, device=dev)

    def build(mats, key):
        data = torch.cat(mats, dim=0)
        if mask32 is not None:
            data = data * mask32.to(data.dtype)
        return Bucket(
            data=data,
            true_dims=torch.tensor(dims_by_bucket[key], dtype=torch.int32, device=dev),
            dims=tuple(dims_by_bucket[key]),
            client_mask=mask32,
            weights=w32,
        )

    buckets = {key: build(mats, key) for key, mats in mats_by_bucket.items()}
    spec = PackSpec(
        entries=tuple(entries),
        skeleton=skeleton,
        n_clients=orig_clients if orig_clients is not None else n_clients_seen[0],
        bucket_dims={k: (b.data.shape[0], b.data.shape[1]) for k, b in buckets.items()},
        cohort_size=n_clients_seen[0],
    )
    return buckets, spec


def unpack(spec: PackSpec, updates: Mapping[BucketKey, torch.Tensor]) -> Tree:
    """Invert ``pack``: per-bucket (total_modules, padded_vec) update arrays
    back to a tree shaped like one client's delta."""

    def rebuild(skel):
        if isinstance(skel, int):
            e = spec.entries[skel]
            rows = updates[e.bucket][e.offset : e.offset + e.n_modules, : e.vec_dim]
            if e.split:
                bounds = [0, *e.split, rows.shape[1]]
                parts = [rows[:, lo:hi] for lo, hi in zip(bounds, bounds[1:])]
            else:
                parts = [rows]
            outs = [p.reshape(shp).to(dt) for p, shp, dt in zip(parts, e.shapes, e.dtypes)]
            if e.kind == "ab_pair":
                return {"A": outs[0], "B": outs[1]}
            return outs[0]
        if isinstance(skel, dict):
            return {k: rebuild(v) for k, v in skel.items()}
        if hasattr(skel, "_fields"):
            return type(skel)(*(rebuild(v) for v in skel))
        return type(skel)(rebuild(v) for v in skel)

    return rebuild(spec.skeleton)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineDiagnostics:
    """Per-module diagnostic tensors keyed by PackSpec bucket; ``spec`` maps
    rows back to tree paths, ``scalars`` holds whole-round scalars."""

    spec: PackSpec
    arrays: Mapping[str, Mapping[BucketKey, torch.Tensor]]
    scalars: Mapping[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def flat(self, name: str) -> torch.Tensor:
        """All modules' values for one diagnostic, bucket order."""
        return torch.cat(list(self.arrays[name].values()))

    def mean(self, name: str) -> torch.Tensor:
        return torch.mean(self.flat(name))

    def max(self, name: str) -> torch.Tensor:
        return torch.max(self.flat(name))

    def per_entry(self, name: str) -> dict:
        """Regroup a diagnostic by tree path: {"/".join(path): (modules,)}."""
        out = {}
        for e in self.spec.entries:
            arr = self.arrays[name][e.bucket][e.offset : e.offset + e.n_modules]
            out["/".join(str(p) for p in e.path)] = arr
        return out


# ---------------------------------------------------------------------------
# Batched per-bucket aggregators
# ---------------------------------------------------------------------------


def _bucket_mean(bucket: Bucket) -> torch.Tensor:
    """Mean over the client axis: unweighted, or the normalized weighted sum
    accumulated in float32."""
    if bucket.weights is None:
        return torch.mean(bucket.data, dim=-1)
    return (bucket.data.to(torch.float32) @ bucket.weights).to(bucket.data.dtype)


def _fedrpca_bucket(
    bucket: Bucket,
    cfg,
    shrink_fn: Callable,
    svt_rank: int | None = None,
    true_cols: int | None = None,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """FedRPCA over one bucket in one ``robust_pca_bucket`` call, or one
    ``robust_pca_bucket_sharded`` call on a multi-shard ``mesh``:
    ((B, vec) update, diagnostics).

    The mask rides into the RPCA (n_eff constants, masked tail) and the
    column means become weighted sums over active clients.
    ``weighting="data_size_rpca"`` column-scales the bucket by the
    n_eff-normalized weights before the split and takes uniform means over
    active clients after it, as the reference's ``col_scale`` branch does.
    """
    m = bucket.data.to(torch.float32)
    col_scaled = cfg.weighting == "data_size_rpca" and bucket.weights is not None
    if bucket.client_mask is None:
        n_eff = float(m.shape[-1])
        w_uniform = None
    else:
        n_eff = torch.clamp_min(torch.sum(bucket.client_mask), 1.0)
        w_uniform = bucket.client_mask / n_eff
    if col_scaled:
        m = m * (bucket.weights * n_eff)[None, None, :]
    rpca_fn = rpca_lib.robust_pca_bucket
    rpca_kwargs = {}
    if rpca_lib.mesh_client_shards(mesh) > 1:
        rpca_fn = rpca_lib.robust_pca_bucket_sharded
        rpca_kwargs = {"mesh": mesh, "mesh_overlap": cfg.mesh_overlap}
    res = rpca_fn(
        m,
        bucket.true_dims,
        n_iter=cfg.rpca_iters,
        tol=None if cfg.rpca_fixed_iters else cfg.rpca_tol,
        shrink_fn=shrink_fn,
        client_mask=bucket.client_mask,
        svt_mode=cfg.svt_mode,
        svt_rank=cfg.svt_rank if svt_rank is None else svt_rank,
        svt_sweeps=cfg.svt_sweeps,
        svt_fallback_tol=cfg.svt_fallback_tol,
        true_cols=true_cols,
        **rpca_kwargs,
    )
    w_post = w_uniform if col_scaled else bucket.weights
    diag_extra = {}
    if cfg.guard_energy_k > 0:
        client_energy = rpca_lib.client_sparse_energy(m, res.sparse)
        gw, flags = rpca_lib.energy_guard_weights(
            client_energy, cfg.guard_energy_k, base_w=w_post, valid=bucket.client_mask,
        )
        low_mean = torch.einsum("mvc,mc->mv", res.low_rank, gw)
        sparse_mean = torch.einsum("mvc,mc->mv", res.sparse, gw)
        diag_extra = {
            "client_energy": torch.amax(client_energy, dim=0),
            "client_flagged": torch.amax(flags, dim=0),
        }
    elif w_post is None:
        low_mean = torch.mean(res.low_rank, dim=-1)
        sparse_mean = torch.mean(res.sparse, dim=-1)
    else:
        low_mean = res.low_rank @ w_post
        sparse_mean = res.sparse @ w_post
    energy = sparse_energy_ratio(m, res.sparse)
    if cfg.adaptive_beta:
        beta = torch.clamp(1.0 / torch.clamp_min(energy, 1e-12), cfg.beta_min, cfg.beta_max)
    else:
        beta = torch.full(energy.shape, cfg.beta, dtype=torch.float32, device=m.device)
    update = low_mean + beta[:, None] * sparse_mean
    diag = {
        "beta": beta, "energy": energy, "residual": res.residual, **diag_extra,
    }
    return update, diag


def aggregate_packed(
    stacked: Tree,
    cfg=None,
    *,
    shrink_fn: Callable = rpca_lib.soft_threshold,
    key=None,
    mask=None,
    weights=None,
    with_diagnostics: bool = False,
    mesh=None,
):
    """Aggregate stacked client deltas with one batched call per bucket.

    Same methods and results as the per-leaf reference path.  ``mask`` /
    ``weights`` are the cohort validity mask and raw weights; masked bucket
    columns are zeroed at pack time.  Diagnostics of fedrpca come back as
    an ``EngineDiagnostics``.

    ``mesh`` shards every bucket's client axis for fedrpca; the means of
    fedavg and task_arithmetic do not depend on it.  A one-shard mesh is
    the unsharded call, bit for bit.
    """
    cfg = cfg or AggregatorConfig()
    method = cfg.method
    dev = tree_leaves(stacked)[0].device
    mask32 = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=dev)
    w = _client_weights(mask32, weights, dev)
    joint = method == "fedrpca" and cfg.joint_ab
    buckets, spec = pack(stacked, joint_ab=joint, client_mask=mask32, weights=w)

    updates: dict[BucketKey, torch.Tensor] = {}
    diag_arrays: dict[str, dict] = {}
    if method == "fedavg":
        for bkey, bucket in buckets.items():
            updates[bkey] = _bucket_mean(bucket)
    elif method == "task_arithmetic":
        for bkey, bucket in buckets.items():
            updates[bkey] = (cfg.beta * _bucket_mean(bucket)).to(bucket.data.dtype)
    elif method == "fedrpca":
        names = ("beta", "energy", "residual") + (
            ("client_energy", "client_flagged") if cfg.guard_energy_k > 0 else ()
        )
        diag_arrays = {k: {} for k in names}
        for bkey, bucket in buckets.items():
            updates[bkey], d = _fedrpca_bucket(
                bucket, cfg, shrink_fn, true_cols=spec.n_clients, mesh=mesh
            )
            for k in names:
                diag_arrays[k][bkey] = d[k]
    else:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md queue 1, item 3)"
        )

    out = unpack(spec, updates)
    if with_diagnostics:
        if not diag_arrays:
            return out, {}
        return out, EngineDiagnostics(spec=spec, arrays=diag_arrays)
    return out
